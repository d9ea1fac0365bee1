// One whole Jacobi-preconditioned PIPECG iteration in one sweep.
//
// Replaces the Pallas TPU kernels
// repro/kernels/pipecg_spmv_fused.py::pipecg_spmv_fused and its per-rank
// form ::pipecg_spmv_halo, which share one _sweep / _kernel there as they
// share this kernel here.  Per right-hand side j and row i it computes
//
//   p' = u + beta p          s' = A p'          q' = diag^-1 s'
//   x' = x + alpha p'        r' = r - alpha s'  u' = u - alpha q'
//   w' = A u'
//
// and the reduction row <r',u'>, <w',u'>, <r',r'>, <r',w'>, <w',w'>,
// sum(w') - sum(c u') (the ABFT checksum residual, c = A^T 1).  Only x, r,
// u and p are written; s, q and w never reach device memory.
//
// Bound on the H100: bytes.  Per row the sweep must read x, r, u, p, the
// n_bands band values, diag^-1 and c, and write x', r', u', p': 13 words
// for the tridiagonal operator at one dtype.  The arithmetic is a few
// dozen flops per row.
//
// Design.
// * Each row's chain once per CTA, in shared memory.  A CTA owns a tile of
//   rows (kernels/pipecg_spmv_fused.py::window_plan: 1020 rows for ex23).
//   w'[i] needs u' on rows i + off_b, each of which needs s' and so p' on
//   rows i + off_b + off_c.  Phase 1 forms p' once per row over the outer
//   window (the tile's rows shifted by every such off_b + off_c, merged
//   into clusters: one [i0 - 2h, i1 + 2h) window for a narrow band, five
//   tile-sized clusters for the 2-D Laplacian's +-nx bands; common.cuh,
//   "row windows").  Phase 2 forms s' and u' once per row over the inner
//   window (shifts off_b), and on the CTA's own rows also x' and r',
//   storing x', r', u', p'.  Phase 3 forms w' on the own rows from the u'
//   window and the reduction terms.  So the band values, diag^-1 and each
//   vector are read once per row from device memory (the own rows' band
//   values once more in phase 3, from L2).  u' is formed by one
//   expression in one order everywhere (s' from zero, bands in order, as
//   spmv_dia_plain; no FMA contraction), so the u' feeding w' is the
//   stored u' and the vectors agree with the plain version bit for bit.
// * Bytes in flight.  A thread takes kBatch = 4 rows at a time and starts
//   all of a batch's loads before the first is used; the tile is chosen
//   so that each window fills whole batches (1024 and 1022 slots for
//   ex23: one batch each).  The band count is a template parameter for 3
//   and 5 bands (the tridiagonal, convection-diffusion and 5-point
//   operators), so the band loops unroll and their loads start together;
//   other counts take the runtime loop.  Launch bounds hold a thread to
//   64 registers, so four CTAs (about 25 KB of shared memory each at
//   float64) share an SM.  Plain loads take any alignment, so odd n with
//   k > 1, bf16/fp8 storage and 2h-row strips need no special case.
// * No padded copies.  Rows of u and p outside [0, n) come from optional
//   strips (k, 2h) to the left and right (null: zero).  The operator
//   (bands and diag^-1) holds rows [-oext, n + oext), row m at column
//   m + oext of an (n_bands, n + 2 oext) array, and is zero beyond them:
//   the single-device sweep passes oext = 0, the per-rank halo sweep
//   (repro/kernels/pipecg_spmv_fused.py::pipecg_spmv_halo) oext = h with
//   the neighbours' operator rows.  The extension is a template flag
//   (Ext), so the oext = 0 instantiation keeps the plain [0, n) operator
//   indexing.  Rows >= n_valid are masked out of the partials.
// * Outputs go to fresh buffers: u and p are read with a +-2h halo across
//   CTAs, so updating them in place would race with a neighbour's reads.
// * Cross-block sums: each thread sums its rows' terms in registers, one
//   block reduction per CTA writes its partial row, and the CTAs finish
//   the sums themselves, in the same launch (common.cuh, finish_rows):
//   up to 1024 CTAs the last to draw an integer ticket sums every row;
//   beyond, the last CTA of each group of 32 sums the group and the last
//   group the group rows.  No float atomics and no second launch; a
//   result repeats bit for bit, and column j of a k-column launch equals
//   a one-column launch on that column.
// * Dtypes: arithmetic in the accumulator T (x's dtype); r, u, p and the
//   operator may be stored narrower (S = bf16 or fp8 e4m3).  Loads widen,
//   and only the r', u', p' stores narrow.
// * alpha and beta are read from (k,) device arrays: no host sync.
#include "common.cuh"

namespace rt {

template <typename T, typename S> struct SweepArgs {
  Offsets offs;
  long long n, n_valid;
  long long ldo;  // operator row stride, n + 2 oext
  int oext, h2, nblk, tile, plan_len;
  const int *plan;
  const S *bands, *invd, *csum;
  const T *x;
  const S *r, *u, *p;
  const S *u_lo, *u_hi, *p_lo, *p_hi;
  const T *alpha, *beta;
  T *xo;
  S *ro, *uo, *po;
  T *partials, *red;
  unsigned int *tickets;
};

// NB > 0: the operator has NB bands, known to the compiler (the band
// loops unroll and their loads start together); NB = 0: a.offs.nb.  Four
// CTAs an SM (at most 64 registers a thread) keep enough loads in flight.
template <typename T, typename S, bool Ext, int NB>
__global__ void __launch_bounds__(kBlock, 4)
    pipecg_sweep_kernel(const SweepArgs<T, S> a) {
  constexpr int R = kBatch, kStep = kBatch * kBlock;
  extern __shared__ __align__(16) unsigned char dyn[];
  const int nb = NB > 0 ? NB : a.offs.nb;
  const Window win = stage_window(dyn, a.plan, a.plan_len, nb);
  T *P = reinterpret_cast<T *>(dyn + ((a.plan_len * 4 + 15) & ~15));
  T *U = P + win.w2;   // u' on the inner window
  T *R2 = U + win.w1;  // r' on the own rows
  const long long j = blockIdx.y;
  const long long i0 = static_cast<long long>(blockIdx.x) * a.tile;
  const int rows = static_cast<int>(min(static_cast<long long>(a.tile),
                                        a.n - i0));
  const T alpha = a.alpha[j], beta = a.beta[j];

  // phase 1: p' = u + beta p on the outer window
  for (int c = 0; c < win.n2; ++c) {
    const int lo = win.cl2[3 * c], w = win.cl2[3 * c + 1];
    T *dst = P + win.cl2[3 * c + 2];
    const bool inside = i0 + lo >= 0 && i0 + lo + w <= a.n;
    for (int s0 = threadIdx.x; s0 < w; s0 += kStep) {
      T uv[R], pv[R];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int s = s0 + q * kBlock;
        const long long m = i0 + lo + s;
        uv[q] = s < w ? row_at<T, S>(a.u, a.u_lo, a.u_hi, j, m, a.n, a.h2,
                                     inside)
                      : T(0);
        pv[q] = s < w ? row_at<T, S>(a.p, a.p_lo, a.p_hi, j, m, a.n, a.h2,
                                     inside)
                      : T(0);
      }
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int s = s0 + q * kBlock;
        if (s < w) dst[s] = uv[q] + beta * pv[q];
      }
    }
  }
  __syncthreads();

  // phase 2: s' and u' on the inner window's other rows ...
  for (int c = 0; c < win.n1; ++c) {
    const int lo = win.cl1[3 * c], w = win.cl1[3 * c + 1];
    T *dst = U + win.cl1[3 * c + 2];
    const int *dt = win.dtab + c * (nb + 1);
    const int own0 = c == win.c_own ? -lo : w;
    const int own1 = c == win.c_own ? rows - lo : w;
    for (int s0 = threadIdx.x; s0 < w; s0 += kStep) {
      T uv[R], iv[R], sv[R];
      bool on[R];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int s = s0 + q * kBlock;
        const long long m = i0 + lo + s;
        on[q] = s < w && (s < own0 || s >= own1);
        uv[q] = on[q] ? vec_at<T, S>(a.u, a.u_lo, a.u_hi, j, m, a.n, a.h2)
                      : T(0);
        iv[q] = on[q] ? band_row<T, S, Ext>(a.invd, 0, m, a.n, a.ldo, a.oext)
                      : T(0);
        sv[q] = T(0);
      }
      for (int b = 0; b < nb; ++b) {
        const int d = dt[b];
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const int s = s0 + q * kBlock;
          if (on[q])
            sv[q] = sv[q] + band_row<T, S, Ext>(a.bands, b, i0 + lo + s, a.n,
                                                a.ldo, a.oext) *
                                P[lo + s + d];
        }
      }
#pragma unroll
      for (int q = 0; q < R; ++q)
        if (on[q]) dst[s0 + q * kBlock] = uv[q] - alpha * (iv[q] * sv[q]);
    }
  }
  // ... and on the own rows, with x', r' and the stores
  {
    const int *dt = win.dtab + win.c_own * (nb + 1);
    const long long jn = j * a.n + i0;
    for (int t0 = threadIdx.x; t0 < rows; t0 += kStep) {
      T uv[R], iv[R], xv[R], rv[R], sv[R];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int t = t0 + q * kBlock;
        const bool ok = t < rows;
        uv[q] = ok ? up<T>(a.u[jn + t]) : T(0);
        iv[q] = ok ? up<T>(a.invd[i0 + t + a.oext]) : T(0);
        xv[q] = ok ? a.x[jn + t] : T(0);
        rv[q] = ok ? up<T>(a.r[jn + t]) : T(0);
        sv[q] = T(0);
      }
      for (int b = 0; b < nb; ++b) {
        const S *band = a.bands + b * a.ldo + i0 + a.oext;
        const int d = dt[b];
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const int t = t0 + q * kBlock;
          if (t < rows) sv[q] = sv[q] + up<T>(band[t]) * P[t + d];
        }
      }
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int t = t0 + q * kBlock;
        if (t >= rows) continue;
        const T p2 = P[win.o2 + t];
        const T u2 = uv[q] - alpha * (iv[q] * sv[q]);
        const T r2 = rv[q] - alpha * sv[q];
        U[win.o1 + t] = u2;
        R2[t] = r2;
        a.xo[jn + t] = xv[q] + alpha * p2;
        a.ro[jn + t] = Store<S>::of(r2);
        a.uo[jn + t] = Store<S>::of(u2);
        a.po[jn + t] = Store<S>::of(p2);
      }
    }
  }

  __syncthreads();

  // phase 3: w' = A u' on the own rows and the reduction terms
  // ru, wu, rr, rw, ww, sum w', sum c u'
  T v[7];
#pragma unroll
  for (int c = 0; c < 7; ++c) v[c] = T(0);
  const int nv = static_cast<int>(
      max(0LL, min(static_cast<long long>(rows), a.n_valid - i0)));
  for (int t0 = threadIdx.x; t0 < nv; t0 += kStep) {
    T cv[R], wv[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int t = t0 + q * kBlock;
      cv[q] = t < nv ? up<T>(a.csum[i0 + t]) : T(0);
      wv[q] = T(0);
    }
    for (int b = 0; b < nb; ++b) {
      const S *band = a.bands + b * a.ldo + i0 + a.oext;
      const int d = win.wtab[b];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int t = t0 + q * kBlock;
        if (t < nv) wv[q] = wv[q] + up<T>(band[t]) * U[t + d];
      }
    }
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int t = t0 + q * kBlock;
      if (t >= nv) continue;
      const T u2 = U[win.o1 + t], r2 = R2[t], w2 = wv[q];
      v[0] += r2 * u2;
      v[1] += w2 * u2;
      v[2] += r2 * r2;
      v[3] += r2 * w2;
      v[4] += w2 * w2;
      v[5] += w2;
      v[6] += cv[q] * u2;
    }
  }
  block_reduce<T, 7>(v);
  // column j's partial rows: (nblk, 6) CTA rows, then (ngroups, 6) groups
  const int ngroups = (a.nblk + kGroup - 1) / kGroup;
  T *part = a.partials + j * (a.nblk + ngroups) * 6;
  if (threadIdx.x == 0) {
    T *out = part + blockIdx.x * 6;
#pragma unroll
    for (int c = 0; c < 5; ++c) out[c] = v[c];
    out[5] = v[5] - v[6];
  }
  T red[6];
  if (finish_rows<T, 6>(part, part + a.nblk * 6,
                        a.tickets + j * (ngroups + 1), a.nblk, red) &&
      threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < 6; ++c) a.red[j * 6 + c] = red[c];
  }
}

template <typename T, typename S, bool Ext, int NB>
static int launch_sweep_nb(const SweepArgs<T, S> &a, int k, int smem,
                    cudaStream_t st) {
  static int granted[kMaxDevices] = {};
  const int e = set_smem(
      reinterpret_cast<const void *>(pipecg_sweep_kernel<T, S, Ext, NB>),
      smem, granted);
  if (e) return e;
  const dim3 grid(static_cast<unsigned>(a.nblk), k);
  pipecg_sweep_kernel<T, S, Ext, NB><<<grid, kBlock, smem, st>>>(a);
  return 0;
}

// the tridiagonal and 5-point operators get their own instantiations
template <typename T, typename S, bool Ext>
int launch_sweep(const SweepArgs<T, S> &a, int k, int smem,
                 cudaStream_t st) {
  switch (a.offs.nb) {
    case 3: return launch_sweep_nb<T, S, Ext, 3>(a, k, smem, st);
    case 5: return launch_sweep_nb<T, S, Ext, 5>(a, k, smem, st);
    default: return launch_sweep_nb<T, S, Ext, 0>(a, k, smem, st);
  }
}

}  // namespace rt

extern "C" int rt_pipecg_spmv_fused(
    int acc, int sto, const int *offsets, int nb, long long n, int k,
    const void *bands, const void *inv_diag, int oext,
    const void *csum, const void *x, const void *r, const void *u,
    const void *p, const void *u_lo, const void *u_hi, const void *p_lo,
    const void *p_hi, int h2, long long n_valid, const void *alpha,
    const void *beta, void *xo, void *ro, void *uo, void *po,
    const void *plan, int plan_len, int tile, int smem, void *partials,
    int nblk, void *tickets, void *red, void *stream) {
  using namespace rt;
  if (nb < 1 || nb > kMaxBands || n < 1 || k < 1 || k > 65535 ||
      tile < 1 || nblk != (n + tile - 1) / tile || h2 < 0 || oext < 0 ||
      plan_len < 8 || smem < 0 || smem > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  Offsets offs{};
  offs.nb = nb;
  for (int b = 0; b < nb; ++b) offs.off[b] = offsets[b];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = with_types(acc, sto, [&](auto ta, auto ts) -> int {
    using T = typename decltype(ta)::type;
    using S = typename decltype(ts)::type;
    SweepArgs<T, S> a{};
    a.offs = offs;
    a.n = n;
    a.n_valid = n_valid;
    a.ldo = n + 2LL * oext;
    a.oext = oext;
    a.h2 = h2;
    a.nblk = nblk;
    a.tile = tile;
    a.plan_len = plan_len;
    a.plan = static_cast<const int *>(plan);
    a.bands = static_cast<const S *>(bands);
    a.invd = static_cast<const S *>(inv_diag);
    a.csum = static_cast<const S *>(csum);
    a.x = static_cast<const T *>(x);
    a.r = static_cast<const S *>(r);
    a.u = static_cast<const S *>(u);
    a.p = static_cast<const S *>(p);
    a.u_lo = static_cast<const S *>(u_lo);
    a.u_hi = static_cast<const S *>(u_hi);
    a.p_lo = static_cast<const S *>(p_lo);
    a.p_hi = static_cast<const S *>(p_hi);
    a.alpha = static_cast<const T *>(alpha);
    a.beta = static_cast<const T *>(beta);
    a.xo = static_cast<T *>(xo);
    a.ro = static_cast<S *>(ro);
    a.uo = static_cast<S *>(uo);
    a.po = static_cast<S *>(po);
    a.partials = static_cast<T *>(partials);
    a.red = static_cast<T *>(red);
    a.tickets = static_cast<unsigned int *>(tickets);
    return oext > 0 ? launch_sweep<T, S, true>(a, k, smem, st)
                    : launch_sweep<T, S, false>(a, k, smem, st);
  });
  if (rc) return rc;
  return static_cast<int>(cudaGetLastError());
}
