// The whole Mehrotra interior-point loop for engine-layout contact systems,
// in two variants: the friction-pair ROTATED one (K = 2C + q <= 48) and the
// UNROTATED one (K = (1 + fd)C + q <= 48).
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
// best-iterate return.  Without a given start (z0 null) the kernel takes
// the solver's own (lcp/pdipm.py::_start) in a pass of the loop's body
// before the first iteration, from the zero iterate, whose residuals are
// the start's right-hand side (rx = p, r2 = h, ry = -b): d_inv = 1, no
// predictor, and the corrector's KKT solve is the origin's Newton step;
// then (s, lam) = (-lam, lam) shifted into the strict interior over the
// real rows and the padded rows pinned.  The pass costs about half an
// iteration and reads no shared memory beyond carve's.  (The same start as
// code of its own before the loop, a second copy of the inverse, spilled
// 200-500 bytes more a thread in every f32 bucket and made K3 ~30% slower:
// PERF.md.)  The wrapper (ops/ipm.py::fused_ipm) forms P = Ghat Q^-1
// Ghat^T and Ghat outside.  The TPU kernel's (K, K) structure
// masks of the unrotated bands are index arithmetic here: row C(1+d)+i
// meets column i and columns C(1+d2)+i.
//
// The TPU kernel keeps a tile of worlds on the vector lanes and skips a
// tile once every lane in it is done.  Here a world is frozen as soon as
// it is done and its warp leaves the loop once every world in it is; that
// is the same result, because a frozen world's iterate and best iterate
// never change again.
//
// What bounds it on an H100: instruction issue, not bytes or FLOPs.  A
// world's inputs are a few KB, read once, and its arithmetic is ~2K^3 per
// iteration; what costs is the instructions around each FMA.  The first
// design (one world per CTA of max(n, m, K) threads, the K x K matrix in
// shared memory with two __syncthreads per pivot, a runtime e / K and a
// three-way branch per entry, ~7.4 KB of shared memory per world) took
// 0.97 ms for K3 and 2.18 ms for K3u at the paths' shapes (B = 4096).
// This design:
//
// - Fixes K at compile time in a bucket KB (16, 24, 32, 48; rows K..KB-1
//   are identity rows with zero right-hand sides, whose zero multipliers
//   leave every real entry exact).  Every loop over the Schur system
//   unrolls and no index division remains.
// - Gives each world L lanes of a warp (L = 16 for KB = 16: two worlds per
//   warp; else L = 32) and 128 / L worlds per CTA.  Lane l owns rows l and
//   l + L of the Schur matrix and of its inverse in registers; a pivot
//   step shuffles the pivot row to every lane (all of it before the
//   reciprocal of its diagonal entry), so the Gauss-Jordan inverse touches
//   no shared memory and needs no barrier.  Barriers are __syncwarp and
//   reductions shuffles within the world's lanes.
// - Keeps every warp whole: no early return (a world past B in the ragged
//   last CTA runs frozen on world B - 1's inputs and stores nothing), and
//   the loop is left by a warp-wide vote once both of a warp's worlds are
//   done; a world done first is frozen (its iterate, best iterate and
//   stall state no longer change) while its partner runs.  So the
//   compiler sees converged warps and issues plain shuffles; with a world
//   leaving by itself it wrapped every shuffle in a convergence sequence
//   (removing them, with the loop changes that came with it, made K3
//   faster and K3u a little slower in a variant run: PERF.md).
// - Keeps in shared memory only P (K x (KB + 16 bytes), padded against
//   bank conflicts), Ghat (K x (n | 1)) and 40 short vectors: 5,936 B per
//   world at the forward slice's K = 16, n = 24, m = 32 f32, 8,368 B at
//   path (c)'s K = 24 (ops/ipm.py::smem_bytes repeats the count of carve
//   below).  At 128 registers a thread (the launch bound for KB <= 32 at
//   f32), K3's 8-world CTAs fit 4 to an SM: 32 worlds, all 4,096 in one
//   wave; K3u's 4-world CTAs also fit 4 to an SM by registers: 16 worlds,
//   two waves.  Sixteen lanes for K3u's 24 rows measured slower, at 128
//   registers (spills) and at 168 (fewer worlds resident).
//
// The inverse matvecs read the right-hand side as 16-byte broadcast loads
// and sum in the order j = 0 .. KB-1, the first design's order plus exact
// zero terms.  f64 at KB = 48 spills (two rows of 48 doubles a lane); it
// is correct and off every default path.

#include <cmath>

#include "common.cuh"

template <typename T>
struct IpmArgs {
  const T *P, *Ghat, *qinv, *p, *h, *b, *mu, *valid, *rmask;
  const T *z0, *s0, *lam0, *nu0;
  T *z, *s, *lam, *nu, *mu_out, *resid;
  int* iters;
  int B, n, m, q, C, fd, max_iter, not_improved_lim, ghat_smem;
  T tol, tiny, reg, dinv_min, dinv_max, stall_rtol;
};

// Rows of the Schur system: rotated 2C + q, unrotated (1 + fd)C + q.
__host__ __device__ inline int schur_rows(int C, int fd, int q, bool rot) {
  return rot ? 2 * C + q : (1 + fd) * C + q;
}

// Lanes of a warp that one world takes, for the bucket KB.
__host__ __device__ constexpr int world_lanes(int KB) {
  return KB == 16 ? 16 : 32;
}

constexpr int CTA_THREADS = 128;

// CTAs per SM that the register budget is set for: 4 (128 registers a
// thread) unless a lane's rows of the inverse alone take more than 48
// registers, then 2.
__host__ __device__ constexpr int min_ctas(int KB, int itemsize) {
  return (KB + world_lanes(KB) - 1) / world_lanes(KB) * KB * itemsize / 4 <= 48
             ? 4 : 2;
}

// Shared-memory arrays of one world, carved from one buffer.
template <typename T>
struct Smem {
  T *P, *Gh;
  T *qinv, *p, *z, *bz, *rx, *dz;
  T *h, *rmask, *s, *lam, *bs, *blam, *rz, *d_inv, *r2, *dlam, *ds, *dlam_a,
      *ds_a;
  T *b, *nu, *bnu, *ry, *dnu;
  T *mu, *valid, *Dginv, *cn, *cf, *delta, *g_u, *bn, *tu;
  T *lamk, *y, *y1, *dmain, *rhs2, *x, *wk;
};

// Row stride of P in shared memory: KB plus 16 bytes, so the 16-byte row
// loads of a quarter warp fall on distinct banks.
template <typename T>
__host__ __device__ constexpr int p_stride(int KB) {
  return KB + 16 / (int)sizeof(T);
}

// Assigns the arrays (when S is not null) and returns the element count of
// one world; every array starts on a 16-byte boundary.
template <typename T>
__host__ __device__ inline size_t carve(Smem<T>* S, T* base, int n, int m,
                                        int q, int C, int K, int KB,
                                        int ghat_smem) {
  const int V = 16 / (int)sizeof(T);
  const int q1 = q > 0 ? q : 1;
  size_t off = 0;
  auto take = [&](T** dst, size_t count) {
    if (S) *dst = base + off;
    off += (count + V - 1) / V * V;
  };
  Smem<T> dummy;
  Smem<T>* d = S ? S : &dummy;
  take(&d->P, (size_t)K * p_stride<T>(KB));
  if (ghat_smem) take(&d->Gh, (size_t)K * (n | 1));
  T** vn[] = {&d->qinv, &d->p, &d->z, &d->bz, &d->rx, &d->dz};
  T** vm[] = {&d->h, &d->rmask, &d->s, &d->lam, &d->bs, &d->blam, &d->rz,
              &d->d_inv, &d->r2, &d->dlam, &d->ds, &d->dlam_a, &d->ds_a};
  T** vq[] = {&d->b, &d->nu, &d->bnu, &d->ry, &d->dnu};
  T** vc[] = {&d->mu, &d->valid, &d->Dginv, &d->cn, &d->cf, &d->delta,
              &d->g_u, &d->bn, &d->tu};
  T** vk[] = {&d->lamk, &d->y, &d->y1, &d->dmain, &d->rhs2, &d->x, &d->wk};
  for (T** a : vn) take(a, n);
  for (T** a : vm) take(a, m);
  for (T** a : vq) take(a, q1);
  for (T** a : vc) take(a, C);
  for (T** a : vk) take(a, KB);
  return off;
}

// sum_j a[j] * v[j] over j < N in order, v in shared memory (16-byte
// aligned), read as 16-byte loads.
template <typename T, int N>
__device__ __forceinline__ T dot_reg(const T (&a)[N], const T* v) {
  using V = typename Vec16<T>::type;
  T acc = T(0);
#pragma unroll
  for (int j = 0; j < N; j += 16 / (int)sizeof(T)) {
    const V c = *reinterpret_cast<const V*>(v + j);
    if constexpr (sizeof(T) == 4) {
      acc += a[j] * c.x;
      acc += a[j + 1] * c.y;
      acc += a[j + 2] * c.z;
      acc += a[j + 3] * c.w;
    } else {
      acc += a[j] * c.x;
      acc += a[j + 1] * c.y;
    }
  }
  return acc;
}

// sum_j u[j] * v[j] over j < N in order, both in shared memory.
template <typename T, int N>
__device__ __forceinline__ T dot_smem(const T* u, const T* v) {
  using V = typename Vec16<T>::type;
  T acc = T(0);
#pragma unroll
  for (int j = 0; j < N; j += 16 / (int)sizeof(T)) {
    const V a = *reinterpret_cast<const V*>(u + j);
    const V c = *reinterpret_cast<const V*>(v + j);
    if constexpr (sizeof(T) == 4) {
      acc += a.x * c.x;
      acc += a.y * c.y;
      acc += a.z * c.z;
      acc += a.w * c.w;
    } else {
      acc += a.x * c.x;
      acc += a.y * c.y;
    }
  }
  return acc;
}

template <typename T, bool ROT, int KB>
struct Ipm {
  static constexpr int L = world_lanes(KB);
  static constexpr int RPL = (KB + L - 1) / L;  // Schur rows per lane
  static constexpr int PS = p_stride<T>(KB);
  const IpmArgs<T>& a;
  Smem<T>& S;
  const T* Gh;
  // gs: Ghat's row stride; mg: kept inequality rows (1 + fd)C; kq: first
  // equality row of the Schur system (rotated 2C, unrotated mg)
  int gs, n, m, q, C, fd, K, mg, kq, ln;
  T sq2, rcount;
  // rows ln + L rr of the Schur matrix, then of its inverse
  T inv[RPL][KB];

  // The whole warp reaches every barrier and shuffle together (no early
  // exit, a loop left only by a warp-wide vote): full-warp masks, and no
  // compiler-inserted convergence sequence around each shuffle.
  __device__ __forceinline__ void sync() const { __syncwarp(); }
  __device__ __forceinline__ T shfl(T v, int src) const {
    return __shfl_sync(0xffffffffu, v, src, L);
  }
  template <typename Op>
  __device__ __forceinline__ T reduce(T v, Op op) const {
#pragma unroll
    for (int o = L / 2; o > 0; o >>= 1)
      v = op(v, __shfl_xor_sync(0xffffffffu, v, o, L));
    return v;
  }
  // contact of friction row r, C <= r < mg: (r - C) % C without a division
  __device__ __forceinline__ int contact_of(int r) const {
    int i = r - C;
    while (i >= C) i -= C;
    return i;
  }
  __device__ __forceinline__ void copy(T* dst, const T* src, int len) const {
    for (int i = ln; i < len; i += L) dst[i] = src[i];
  }
  // (Ghat v)[k] and (Ghat^T v)[j]
  __device__ __forceinline__ T gh_row(int k, const T* v) const {
    const T* g = Gh + (size_t)k * gs;
    T acc = T(0);
#pragma unroll 4
    for (int j = 0; j < n; ++j) acc += g[j] * v[j];
    return acc;
  }
  __device__ __forceinline__ T gh_col(int j, const T* v) const {
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < KB; ++k)
      if (k < K) acc += Gh[(size_t)k * gs + j] * v[k];
    return acc;
  }

  // rx (n), rz (m), ry (q) at the current iterate; returns (mu_c, resid).
  __device__ __forceinline__ void measures(T& mu_c, T& resid) {
    if constexpr (ROT) {
      for (int i = ln; i < C; i += L) {
        S.lamk[i] = S.lam[i];
        S.lamk[C + i] = (S.lam[C + i] - S.lam[2 * C + i]) / sq2;
      }
    } else {
      for (int k = ln; k < mg; k += L) S.lamk[k] = S.lam[k];
    }
    for (int k = ln; k < q; k += L) S.lamk[kq + k] = S.nu[k];
    // rotated [G_c z; sqrt2 G_f1 z; A z], else [G_kept z; A z]
    for (int k = ln; k < K; k += L) S.y[k] = gh_row(k, S.z);
    sync();
    T part_mu = T(0), part_res = T(0);
    for (int j = ln; j < n; j += L) {
      const T r = T(1) / S.qinv[j] * S.z[j] + S.p[j] + gh_col(j, S.lamk);
      S.rx[j] = r;
      part_res = nmax(part_res, fabs(r));
    }
    for (int r = ln; r < m; r += L) {
      T gz;
      if (r < C) {
        gz = S.y[r];
      } else if (r < mg) {
        const int i = contact_of(r);
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
    for (int k = ln; k < q; k += L) {
      const T v = S.y[kq + k] - S.b[k];
      S.ry[k] = v;
      part_res = nmax(part_res, fabs(v));
    }
    mu_c = reduce(part_mu, SumOp()) / rcount;
    resid = reduce(part_res, MaxOp());
    sync();
  }

  // Row i < K of S x from S's structured form (x zero past K).
  __device__ __forceinline__ T apply_S_row(int i, const T* x) const {
    T ax = -dot_smem<T, KB>(S.P + i * PS, x) - S.dmain[i] * x[i];
    if constexpr (ROT) {
      if (i >= C && i < 2 * C) ax += S.bn[i - C] * x[i - C];
    } else {
      if (i >= C && i < mg) {
        const int ci = contact_of(i);
        T xf = T(0);
        for (int d = 0; d < fd; ++d) xf += x[C * (1 + d) + ci];
        ax = ax + (S.cn[ci] * x[ci] + S.cf[ci] * xf);
      }
    }
    return ax;
  }

  // out = S^-1 rhs plus one refinement step against the structured S; rhs
  // (zero past K) is overwritten by the residual.
  __device__ __forceinline__ void solve_S(T* rhs, T* out) {
    T xr[RPL];
#pragma unroll
    for (int rr = 0; rr < RPL; ++rr) {
      xr[rr] = dot_reg<T, KB>(inv[rr], rhs);
      const int i = ln + L * rr;
      if (i < K) S.x[i] = xr[rr];
    }
    sync();
#pragma unroll
    for (int rr = 0; rr < RPL; ++rr) {
      const int i = ln + L * rr;
      if (i < K) rhs[i] = rhs[i] - apply_S_row(i, S.x);
    }
    sync();
#pragma unroll
    for (int rr = 0; rr < RPL; ++rr) {
      const T acc = dot_reg<T, KB>(inv[rr], rhs);
      const int i = ln + L * rr;
      if (i < K) out[i] = xr[rr] + acc;
    }
    sync();
  }

  // KKT solve (trans=0) for rhs [-rx; r2; -ry] with S.y1 = Ghat (qinv
  // -rx) precomputed; dz and dnu may be null.  Rotated:
  // _rot_factor_factory's solve; unrotated: factor_schur_gamma's with the
  // ConeF coupling.
  __device__ __forceinline__ void kkt_solve(T* dz, T* dlam, T* dnu) {
    const T* r2 = S.r2;
    if constexpr (ROT) {
      for (int i = ln; i < C; i += L) {
        const T tD = S.Dginv[i] * r2[mg + i];
        const T ru = (r2[C + i] + r2[2 * C + i]) / sq2;
        const T rv = (r2[C + i] - r2[2 * C + i]) / sq2;
        const T t_u = ru - sq2 * S.valid[i] * tD;
        S.rhs2[i] = r2[i] - S.y1[i];
        S.rhs2[C + i] = (rv - S.y1[C + i]) - (S.delta[i] / S.g_u[i]) * t_u;
        S.tu[i] = t_u;
      }
    } else {
      for (int k = ln; k < mg; k += L) {
        T v = r2[k] - S.y1[k];
        if (k >= C) {  // the gamma rows' coupling: -valid Dginv tg
          const int ci = contact_of(k);
          v = v + (-S.valid[ci] * (S.Dginv[ci] * r2[mg + ci]));
        }
        S.rhs2[k] = v;
      }
    }
    for (int k = ln; k < q; k += L) S.rhs2[kq + k] = -S.ry[k] - S.y1[kq + k];
    sync();
    solve_S(S.rhs2, S.wk);
    if constexpr (ROT) {
      for (int i = ln; i < C; i += L) {
        const T w_c = S.wk[i], w_v = S.wk[C + i];
        const T w_u = (S.tu[i] - sq2 * S.cn[i] * w_c - S.delta[i] * w_v) / S.g_u[i];
        dlam[i] = w_c;
        dlam[C + i] = (w_u + w_v) / sq2;
        dlam[2 * C + i] = (w_u - w_v) / sq2;
        dlam[mg + i] = -S.Dginv[i]
                       * (r2[mg + i] - (-S.mu[i] * w_c + sq2 * S.valid[i] * w_u));
      }
    } else {
      for (int k = ln; k < mg; k += L) dlam[k] = S.wk[k];
      for (int i = ln; i < C; i += L) {
        T wf = T(0);  // every friction direction of contact i
        for (int d = 0; d < fd; ++d) wf += S.wk[C * (1 + d) + i];
        dlam[mg + i] = -S.Dginv[i]
                       * (r2[mg + i] - (-S.mu[i] * S.wk[i] + S.valid[i] * wf));
      }
    }
    if (dnu)
      for (int k = ln; k < q; k += L) dnu[k] = S.wk[kq + k];
    if (dz)
      for (int j = ln; j < n; j += L)
        dz[j] = S.qinv[j] * (-S.rx[j] - gh_col(j, S.wk));
    sync();
  }

  // The Schur system S of the scaling d_inv, formed in the lanes' rows of
  // inv (identity rows past K), with its diagonal dmain and band
  // coefficients kept for apply_S_row.
  __device__ __forceinline__ void assemble() {
    for (int i = ln; i < C; i += L) {
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
      for (int k = ln; k < q; k += L) S.dmain[2 * C + k] = a.reg;
    } else {
      for (int k = ln; k < K; k += L)
        S.dmain[k] = k < mg ? S.d_inv[k] + a.reg : a.reg;
    }
    sync();
#pragma unroll
    for (int rr = 0; rr < RPL; ++rr) {
      const int i = ln + L * rr;
      const bool real = i < K;
      const T* Pi = S.P + (real ? i : 0) * PS;
      const T dm = real ? S.dmain[i] : T(0);
      // the row's band entries: rotated (i, i - C) for a v row; unrotated
      // cn at (i, ci) and cf at (i, C(1+d) + ci) for a friction row
      int bc = -1, cfc = -1;
      T bv = T(0), cfv = T(0);
      if constexpr (ROT) {
        if (real && i >= C && i < 2 * C) {
          bc = i - C;
          bv = S.bn[bc];
        }
      } else {
        if (real && i >= C && i < mg) {
          bc = contact_of(i);
          bv = S.cn[bc];
          cfc = C + bc;
          cfv = S.cf[bc];
        }
      }
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        T v = -Pi[j];
        if (j == i) v = v - dm;
        if (j == bc) v = v + bv;
        if constexpr (!ROT) {
          if (j == cfc && j < mg) {
            v = v + cfv;
            cfc += C;
          }
        }
        inv[rr][j] = real ? v : (j == i ? T(1) : T(0));
      }
    }
  }

  // inv <- inv^-1 by in-place pivotless Gauss-Jordan over the K real
  // pivots (the rows and columns past K are identity and stay so).  Pivot
  // k's row lives in lane k % L's register row k / L and is broadcast one
  // entry at a time; each lane updates its own rows.
  __device__ __forceinline__ void invert() {
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      if (k < K) {
        const int kl = k % L, kr = k / L;
        // the pivot row, all shuffled before the reciprocal of its
        // diagonal entry
        T rowk[KB];
#pragma unroll
        for (int j = 0; j < KB; ++j) rowk[j] = shfl(inv[kr][j], kl);
        const T dinv = safe_inv(rowk[k]);
        T ci[RPL];
#pragma unroll
        for (int rr = 0; rr < RPL; ++rr) ci[rr] = inv[rr][k];
#pragma unroll
        for (int j = 0; j < KB; ++j) {
          T rj = T(0);
          if (j != k) rj = rowk[j] * dinv;
#pragma unroll
          for (int rr = 0; rr < RPL; ++rr) {
            const bool mine = ln + L * rr == k;
            T v;
            if (j == k) v = mine ? dinv : -ci[rr] * dinv;
            else v = mine ? rj : inv[rr][j] - ci[rr] * rj;
            inv[rr][j] = v;
          }
        }
      }
    }
  }

  // min(1, largest alpha keeping s + alpha ds, lam + alpha dlam >= 0 on
  // real rows)
  __device__ __forceinline__ T max_step(const T* ds, const T* dl) const {
    const T inf = T(INFINITY);
    T r = inf;
    for (int i = ln; i < m; i += L) {
      if (S.rmask[i] > T(0)) {
        if (ds[i] < T(0)) r = fmin(r, -S.s[i] / ds[i]);
        if (dl[i] < T(0)) r = fmin(r, -S.lam[i] / dl[i]);
      }
    }
    r = reduce(r, MinOp());
    return r < T(1) ? r : T(1);
  }

  // The start from the origin's Newton step (z, lam, nu) = (dz, dlam,
  // dnu): s = -lam, then s and lam each shifted by relu(1 - their least
  // entry over the real rows) and the padded rows pinned at s = h, lam =
  // tiny.  (The best iterate needs no copy: it is returned only after an
  // iteration improved on it, which copies it.)
  __device__ __forceinline__ void take_start() {
    const T inf = T(INFINITY);
    T ms = inf, ml = inf;
    for (int r = ln; r < m; r += L)
      if (S.rmask[r] > T(0)) {
        ms = fmin(ms, -S.dlam[r]);
        ml = fmin(ml, S.dlam[r]);
      }
    ms = reduce(ms, MinOp());
    ml = reduce(ml, MinOp());
    const T shift_s = nmax(T(1) - ms, T(0)), shift_l = nmax(T(1) - ml, T(0));
    for (int j = ln; j < n; j += L) S.z[j] = S.dz[j];
    for (int r = ln; r < m; r += L) {
      const bool real = S.rmask[r] > T(0);
      S.s[r] = real ? -S.dlam[r] + shift_s : S.h[r];
      S.lam[r] = real ? S.dlam[r] + shift_l : a.tiny;
    }
    for (int k = ln; k < q; k += L) S.nu[k] = S.dnu[k];
    sync();
  }

  // live: the world is one of the batch's (a world past B in the ragged
  // last CTA runs frozen on a copy of world B - 1 and stores nothing).
  // own_start: the pass it = -1 takes the start (header) instead of an
  // iteration; it is the same for every world of the launch, so the
  // pass's branches are warp-uniform.
  __device__ __forceinline__ void run(size_t w, bool live, bool own_start) {
    const T big = (sizeof(T) == 8 ? T(1.7976931348623157e308)
                                  : T(3.4028234663852886e38)) / T(8);
    T best_merit = big, stall = T(0);
    int iters = a.max_iter;
    const int lim = a.not_improved_lim;
    T mu_c, resid;
    bool done = !live;
    for (int it = own_start ? -1 : 0; it < a.max_iter; ++it) {
      const bool start = it < 0;
      // a done world is frozen; the warp goes on while either of its worlds
      // runs (an idle half costs no issue slot of its own)
      if (!start && __all_sync(0xffffffffu, done)) break;
      // at the start's zero iterate: rx = p, ry = -b, rz = -h
      measures(mu_c, resid);
      if (!start && !done) {
        const T merit = mu_c + resid;
        const bool improved = merit < best_merit;
        if (improved) {
          copy(S.bz, S.z, n);
          copy(S.bs, S.s, m);
          copy(S.blam, S.lam, m);
          copy(S.bnu, S.nu, q);
        }
        const bool sig = a.stall_rtol > T(0)
                             ? merit < best_merit * (T(1) - a.stall_rtol)
                             : improved;
        best_merit = nmin(merit, best_merit);
        stall = sig ? T(0) : stall + T(1);
        const bool stalled = lim > 0 && stall >= T(lim) && it >= lim + 2;
        if (merit < a.tol || stalled) {
          iters = it;  // done: frozen from here on
          done = true;
        }
      }

      // ---- Schur assembly + in-place Gauss-Jordan inverse -------------
      for (int r = ln; r < m; r += L)
        S.d_inv[r] = start ? T(1)
                           : clip(S.s[r] / nmax(S.lam[r], a.tiny), a.dinv_min,
                                  a.dinv_max);
      sync();
      assemble();
      invert();

      // ---- predictor (at the start's zero iterate r2 = h) -------------
      for (int j = ln; j < n; j += L) S.dz[j] = S.qinv[j] * -S.rx[j];
      for (int r = ln; r < m; r += L)
        S.r2[r] = -S.rz[r] + (S.s[r] * S.lam[r]) / nmax(S.lam[r], a.tiny);
      sync();
      // Ghat (qinv r1), shared by both solves
      for (int k = ln; k < K; k += L) S.y1[k] = gh_row(k, S.dz);
      sync();
      if (!start) {
        kkt_solve(nullptr, S.dlam_a, nullptr);
        for (int r = ln; r < m; r += L)
          S.ds_a[r] = -(S.s[r] * S.lam[r]) / nmax(S.lam[r], a.tiny)
                      - S.d_inv[r] * S.dlam_a[r];
        sync();
        const T alpha_a = max_step(S.ds_a, S.dlam_a);
        T part = T(0);
        for (int r = ln; r < m; r += L)
          if (S.rmask[r] > T(0))
            part += (S.s[r] + alpha_a * S.ds_a[r]) * (S.lam[r] + alpha_a * S.dlam_a[r]);
        const T mu_aff = reduce(part, SumOp()) / rcount;
        const T sg = clip(mu_aff / nmax(mu_c, a.tiny), T(0), T(1));
        const T sigma = sg * sg * sg;

        // ---- corrector (r4c held in ds until the solve is done) --------
        for (int r = ln; r < m; r += L) {
          const T r4c = S.s[r] * S.lam[r] + S.ds_a[r] * S.dlam_a[r] - sigma * mu_c;
          S.ds[r] = r4c;
          S.r2[r] = -S.rz[r] + r4c / nmax(S.lam[r], a.tiny);
        }
        sync();
      }
      // the corrector's solve, or the start's one Newton step
      kkt_solve(S.dz, S.dlam, S.dnu);
      if (start) {
        take_start();
        continue;
      }
      for (int r = ln; r < m; r += L)
        S.ds[r] = -S.ds[r] / nmax(S.lam[r], a.tiny) - S.d_inv[r] * S.dlam[r];
      sync();
      const T alpha = T(0.99) * max_step(S.ds, S.dlam);

      // new iterate into the direction arrays, committed if all finite
      T bad = T(0);
      for (int j = ln; j < n; j += L) {
        const T v = S.z[j] + alpha * S.dz[j];
        S.dz[j] = v;
        if (!isfinite(v)) bad = T(1);
      }
      for (int r = ln; r < m; r += L) {
        const bool real = S.rmask[r] > T(0);  // padded rows pinned
        const T sn = real ? nmax(S.s[r] + alpha * S.ds[r], a.tiny) : S.h[r];
        const T lnew = real ? nmax(S.lam[r] + alpha * S.dlam[r], a.tiny) : a.tiny;
        if (!isfinite(sn) || !isfinite(lnew)) bad = T(1);
        S.ds[r] = sn;
        S.dlam[r] = lnew;
      }
      for (int k = ln; k < q; k += L) S.dnu[k] = S.nu[k] + alpha * S.dnu[k];
      const bool halt = reduce(bad, MaxOp()) > T(0);  // non-finite: frozen
      if (!done && !halt) {
        copy(S.z, S.dz, n);
        copy(S.s, S.ds, m);
        copy(S.lam, S.dlam, m);
        copy(S.nu, S.dnu, q);
      }
      done = done || halt;
      sync();
    }

    // return the best iterate seen (non-monotone tails)
    measures(mu_c, resid);
    if (best_merit < mu_c + resid) {
      copy(S.z, S.bz, n);
      copy(S.s, S.bs, m);
      copy(S.lam, S.blam, m);
      copy(S.nu, S.bnu, q);
    }
    sync();  // outside the branch: the warp's other world reaches it too
    measures(mu_c, resid);
    if (!live) return;
    for (int j = ln; j < n; j += L) a.z[w * n + j] = S.z[j];
    for (int r = ln; r < m; r += L) {
      a.s[w * m + r] = S.s[r];
      a.lam[w * m + r] = S.lam[r];
    }
    for (int k = ln; k < q; k += L) a.nu[w * q + k] = S.nu[k];
    if (ln == 0) {
      a.mu_out[w] = mu_c;
      a.resid[w] = resid;
      a.iters[w] = iters;
    }
  }
};

// 128 / L worlds per CTA, L lanes each.  A world of the ragged last CTA
// past B runs frozen on world B - 1's inputs and stores nothing, so every
// warp stays whole.
template <typename T, bool ROT, int KB>
__global__ void __launch_bounds__(CTA_THREADS, min_ctas(KB, sizeof(T)))
    fused_ipm_kernel(IpmArgs<T> a) {
  constexpr int L = world_lanes(KB);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int seg = threadIdx.x / L, ln = threadIdx.x % L;
  const size_t wr = (size_t)blockIdx.x * (blockDim.x / L) + seg;
  const bool live = wr < (size_t)a.B;
  const size_t w = live ? wr : (size_t)a.B - 1;
  const int n = a.n, m = a.m, q = a.q, C = a.C;
  const int K = schur_rows(C, a.fd, q, ROT);
  const size_t per = carve<T>(nullptr, nullptr, n, m, q, C, K, KB, a.ghat_smem);
  Smem<T> S;
  carve<T>(&S, reinterpret_cast<T*>(smem_raw) + seg * per, n, m, q, C, K, KB,
           a.ghat_smem);
  constexpr int PS = p_stride<T>(KB);
  const T* Pg = a.P + w * K * K;
  for (int e = ln; e < K * KB; e += L) {  // P, zero past column K
    const int i = e / KB, j = e % KB;
    S.P[i * PS + j] = j < K ? Pg[i * K + j] : T(0);
  }
  const int gs = a.ghat_smem ? (n | 1) : n;
  const T* Ghg = a.Ghat + w * K * n;
  if (a.ghat_smem)
    for (int e = ln; e < K * n; e += L) S.Gh[(e / n) * gs + e % n] = Ghg[e];
  T* vk[] = {S.lamk, S.y, S.y1, S.dmain, S.rhs2, S.x, S.wk};
  for (T* v : vk)  // zero past K: the inverse matvecs read all KB entries
    for (int k = ln; k < KB; k += L) v[k] = T(0);
  // the given start, or the zero iterate the start's pass begins from
  const bool own_start = a.z0 == nullptr;
  for (int j = ln; j < n; j += L) {
    S.qinv[j] = a.qinv[w * n + j];
    S.p[j] = a.p[w * n + j];
    S.z[j] = S.bz[j] = own_start ? T(0) : a.z0[w * n + j];
  }
  for (int r = ln; r < m; r += L) {
    S.h[r] = a.h[w * m + r];
    S.rmask[r] = a.rmask[w * m + r];
    S.s[r] = S.bs[r] = own_start ? T(0) : a.s0[w * m + r];
    S.lam[r] = S.blam[r] = own_start ? T(0) : a.lam0[w * m + r];
  }
  for (int k = ln; k < q; k += L) {
    S.b[k] = a.b[w * q + k];
    S.nu[k] = S.bnu[k] = own_start ? T(0) : a.nu0[w * q + k];
  }
  for (int i = ln; i < C; i += L) {
    S.mu[i] = a.mu[w * C + i];
    S.valid[i] = a.valid[w * C + i];
  }
  T cnt = T(0);
  for (int r = ln; r < m; r += L) cnt += S.rmask[r];
  for (int o = L / 2; o > 0; o >>= 1)
    cnt += __shfl_xor_sync(0xffffffffu, cnt, o, L);
  __syncwarp();
  const int mg = m - C;
  Ipm<T, ROT, KB> ipm{a, S, a.ghat_smem ? S.Gh : Ghg, gs, n, m, q, C, a.fd,
                      K, mg, ROT ? 2 * C : mg, ln, sqrt(T(2)),
                      cnt > T(1) ? cnt : T(1)};
  ipm.run(w, live, own_start);
}

template <typename T>
static size_t world_bytes(int n, int m, int q, int C, int fd, int rot, int KB,
                          int ghat_smem) {
  return carve<T>(nullptr, nullptr, n, m, q, C, schur_rows(C, fd, q, rot), KB,
                  ghat_smem) * sizeof(T);
}

// The wrapper (ops/ipm.py) picks the bucket KB, the worlds per CTA W and
// whether Ghat is in shared memory (a.ghat_smem), within the card's limit.
template <typename T, bool ROT, int KB>
static int launch_kb(IpmArgs<T> a, int W, void* stream) {
  constexpr int L = world_lanes(KB);
  const int K = schur_rows(a.C, a.fd, a.q, ROT);
  if (K > KB || K < 1 || W < 1 || W * L > CTA_THREADS)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      W * world_bytes<T>(a.n, a.m, a.q, a.C, a.fd, ROT, KB, a.ghat_smem);
  cudaError_t e = cudaFuncSetAttribute(
      fused_ipm_kernel<T, ROT, KB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (a.B > 0)
    fused_ipm_kernel<T, ROT, KB><<<(a.B + W - 1) / W, W * L, smem,
                                   (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool ROT>
static int launch(IpmArgs<T> a, int KB, int W, void* stream) {
  clear_last_error();
  switch (KB) {
    case 16: return launch_kb<T, ROT, 16>(a, W, stream);
    case 24: return launch_kb<T, ROT, 24>(a, W, stream);
    case 32: return launch_kb<T, ROT, 32>(a, W, stream);
    case 48: return launch_kb<T, ROT, 48>(a, W, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

#define LCP_FUSED_IPM_ENTRY(NAME, T)                                          \
  int NAME(const T* P, const T* Ghat, const T* qinv, const T* p, const T* h,  \
           const T* b, const T* mu, const T* valid, const T* rmask,           \
           const T* z0, const T* s0, const T* lam0, const T* nu0, T* z, T* s, \
           T* lam, T* nu, T* mu_out, T* resid, int* iters, int B, int n,      \
           int m, int q, int C, int fd, int rot, int max_iter, double tol,    \
           double tiny, double reg, double dinv_min, double dinv_max,         \
           int not_improved_lim, double stall_rtol, int ghat_smem, int KB,    \
           int W, void* stream) {                                             \
    IpmArgs<T> a{P,  Ghat, qinv,  p,   h,      b,     mu,    valid,          \
                 rmask, z0, s0,   lam0, nu0,   z,     s,     lam,            \
                 nu, mu_out, resid, iters, B, n, m, q, C, fd, max_iter,       \
                 not_improved_lim, ghat_smem, T(tol), T(tiny), T(reg),        \
                 T(dinv_min), T(dinv_max), T(stall_rtol)};                    \
    return rot ? launch<T, true>(a, KB, W, stream)                            \
               : launch<T, false>(a, KB, W, stream);                          \
  }

extern "C" {
LCP_FUSED_IPM_ENTRY(lcp_fused_ipm_f32, float)
LCP_FUSED_IPM_ENTRY(lcp_fused_ipm_f64, double)

// Shared memory one world needs in bucket KB (Ghat in shared memory or
// not); ops/ipm.py::smem_bytes repeats the count.
long long lcp_fused_ipm_smem_bytes(int n, int m, int q, int C, int fd,
                                   int rot, int f64, int KB, int ghat_smem) {
  return f64 ? (long long)world_bytes<double>(n, m, q, C, fd, rot, KB, ghat_smem)
             : (long long)world_bytes<float>(n, m, q, C, fd, rot, KB, ghat_smem);
}
}
