// One whole pipelined BiCGStab iteration in one sweep.
//
// Replaces the Pallas TPU kernels
// repro/kernels/pipebicgstab_fused.py::pipebicgstab_fused and its per-rank
// form ::pipebicgstab_halo, which share one _sweep there as they share this
// kernel here.  Given alpha, beta, omega, per row i it computes
//
//   p  = r + beta pa        s  = w + beta a        z  = t + beta c
//   v  = A z
//   q  = r - alpha s        y  = w - alpha z
//   x' = x + alpha p + omega q
//   r' = q - omega y        w' = y - omega (t - alpha v)
//   t' = A w'
//   pa' = p - omega s       a' = s - omega z       c' = z - omega v
//
// and the (7, 6) payload: the Gram matrix of [r', w', t', a', c', r_hat]
// and, in row 6, the ABFT checksum residual sum(t') - sum(c w') of the
// second SpMV (c = A^T 1).  v, z, s, q, y and p never reach device memory.
//
// Bound on the H100: bytes.  Per row the sweep must read x, r, pa, a,
// r_hat, w, t, c, the n_bands band values and c = A^T 1, and write x', r',
// w', t', pa', a', c': 16 + n_bands words, 19 for the tridiagonal operator
// at one dtype.  The arithmetic is a few dozen flops per row plus the
// chain's recompute.
//
// Design.
// * Each row's chain once per CTA, in shared memory, as the PIPECG sweep
//   (csrc/pipecg_spmv_fused.cu) does.  t'[i] needs w' on rows i + off_b,
//   each of which needs v = A z and so z on rows i + off_b + off_c.  A
//   CTA owns a tile of rows (pipecg_spmv_fused.py::window_plan: 2044 rows
//   for a tridiagonal operator).  Phase 1 forms z once per row over the
//   outer window (the tile's rows shifted by every off_b + off_c, merged
//   into clusters; common.cuh, "row windows").  Phase 2 forms v and w'
//   once per row over the inner window (shifts off_b), and on the CTA's
//   own rows all the other updates, storing x', r', w', pa', a', c' and
//   keeping r', a', c' in shared memory.  Phase 3 forms t' on the own rows
//   from the w' window, stores it and sums the Gram terms.  So the band
//   values and each vector are read once per row from device memory (the
//   own rows' band values once more in phase 3, from L2), and w' is
//   formed by one expression in one order everywhere (v from zero, bands
//   in order; no FMA contraction): the w' feeding t' is the stored w', and
//   the vectors agree with the plain version bit for bit.
// * Bytes in flight.  A thread takes kBatch = 4 rows at a time and starts
//   all of a batch's loads before the first is used; the loads of its
//   first own-row batch (r, w, t, pa, a, x) start before the window
//   table is staged, so they travel during phase 1.  The band count is a
//   template parameter for 3 and 5 bands.  The 23 accumulators and a
//   batch take about 125 registers, so two CTAs (82 KB of shared memory
//   each at float64) share an SM; capping the registers to fit more
//   spilled and ran slower.  Plain loads take any alignment.
// * No padded copies.  Rows of w, t and c outside [0, n) come from
//   optional (2h,) strips to the left and right (null: zero).  The bands
//   hold the operator rows [-oext, n + oext), row m at column m + oext of
//   an (n_bands, n + 2 oext) array, and read as zero beyond them: the
//   single-device sweep passes oext = 0, the per-rank sweep oext = h with
//   the neighbours' rows.  As in the PIPECG sweep the extension is a
//   template flag (Ext), so oext = 0 keeps the plain [0, n) indexing.
//   Rows >= n_valid are masked out of the payload.
// * Outputs go to fresh buffers: w, t and c are read with a +-2h halo
//   across CTAs, so updating them in place would race with a neighbour.
// * Cross-block sums: each thread sums its rows' 21 Gram products, sum t'
//   and sum c w' in registers; one block reduction per CTA writes its
//   (n_blocks, 22) partial row (the checksum as one entry), and the CTAs
//   finish in the same launch, in two fixed-order levels with integer
//   tickets (common.cuh, finish_rows: the last CTA of each group of 32
//   sums the group while the others still run, the last group the group
//   rows) and fill the symmetric (7, 6) payload.  No float atomics and no
//   second launch, so results repeat bit for bit.
// * Dtypes: arithmetic, x, c = A^T 1 and the payload in the accumulator T;
//   the chains r, w, t, pa, a, c, r_hat and the bands may be stored
//   narrower (S = bf16 or fp8 e4m3).  Loads widen, only the six chain
//   stores narrow, and r_hat is only read.
// * alpha, beta and omega are read from device scalars: no host sync.
#include "common.cuh"

namespace rt {

// 21 unique Gram entries of the 6-vector basis + sum t' + sum c w'
constexpr int kGramCols = 21;
constexpr int kBicgCols = kGramCols + 2;
constexpr int kBicgPartials = kGramCols + 1;

template <typename T, typename S> struct BicgArgs {
  Offsets offs;
  long long n, n_valid;
  long long ldo;  // operator row stride, n + 2 oext
  int oext, h2, nblk, tile, plan_len;
  const int *plan;
  const S *bands;
  const T *csum;
  const T *x;
  const S *r, *w, *t, *pa, *a, *c, *rh;
  const S *w_lo, *w_hi, *t_lo, *t_hi, *c_lo, *c_hi;
  const T *alpha, *beta, *omega;
  T *xo;
  S *ro, *wo, *to, *pao, *ao, *co;
  T *partials, *gram;
  unsigned int *tickets;  // ngroups + 1 (finish_rows)
};

// NB > 0: the operator has NB bands, known to the compiler; NB = 0:
// g.offs.nb
template <typename T, typename S, bool Ext, int NB>
__global__ void __launch_bounds__(kBlock)
    pipebicgstab_sweep_kernel(const BicgArgs<T, S> g) {
  constexpr int R = kBatch, kStep = kBatch * kBlock;
  const long long i0 = static_cast<long long>(blockIdx.x) * g.tile;
  const int rows = static_cast<int>(min(static_cast<long long>(g.tile),
                                        g.n - i0));
  // the own-row operands of a thread's first phase-2 batch are loaded
  // first, so they travel while the window table is staged and phase 1
  // runs
  T rv[R], wv[R], tv[R], pv[R], av[R], xv[R];
  auto load_own = [&](int t0) {
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int t = t0 + q * kBlock;
      const bool ok = t < rows;
      const long long i = i0 + t;
      rv[q] = ok ? up<T>(g.r[i]) : T(0);
      wv[q] = ok ? up<T>(g.w[i]) : T(0);
      tv[q] = ok ? up<T>(g.t[i]) : T(0);
      pv[q] = ok ? up<T>(g.pa[i]) : T(0);
      av[q] = ok ? up<T>(g.a[i]) : T(0);
      xv[q] = ok ? g.x[i] : T(0);
    }
  };
  load_own(threadIdx.x);

  extern __shared__ __align__(16) unsigned char dyn[];
  const int nb = NB > 0 ? NB : g.offs.nb;
  const Window win = stage_window(dyn, g.plan, g.plan_len, nb);
  T *Z = reinterpret_cast<T *>(dyn + ((g.plan_len * 4 + 15) & ~15));
  T *W = Z + win.w2;     // w' on the inner window
  T *R2 = W + win.w1;    // r', a', c' on the own rows
  T *A2 = R2 + g.tile;
  T *C2 = A2 + g.tile;
  const T al = *g.alpha, be = *g.beta, om = *g.omega;

  // phase 1: z = t + beta c on the outer window
  for (int c = 0; c < win.n2; ++c) {
    const int lo = win.cl2[3 * c], w = win.cl2[3 * c + 1];
    T *dst = Z + win.cl2[3 * c + 2];
    const bool inside = i0 + lo >= 0 && i0 + lo + w <= g.n;
    for (int s0 = threadIdx.x; s0 < w; s0 += kStep) {
      T tv[R], cv[R];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int s = s0 + q * kBlock;
        const long long m = i0 + lo + s;
        tv[q] = s < w ? row_at<T, S>(g.t, g.t_lo, g.t_hi, 0, m, g.n, g.h2,
                                     inside)
                      : T(0);
        cv[q] = s < w ? row_at<T, S>(g.c, g.c_lo, g.c_hi, 0, m, g.n, g.h2,
                                     inside)
                      : T(0);
      }
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int s = s0 + q * kBlock;
        if (s < w) dst[s] = tv[q] + be * cv[q];
      }
    }
  }
  __syncthreads();

  // phase 2: v = A z and w' = (w - alpha z) - omega (t - alpha v) on the
  // inner window's other rows ...
  for (int c = 0; c < win.n1; ++c) {
    const int lo = win.cl1[3 * c], w = win.cl1[3 * c + 1];
    T *dst = W + win.cl1[3 * c + 2];
    const int *dt = win.dtab + c * (nb + 1);
    const int own0 = c == win.c_own ? -lo : w;
    const int own1 = c == win.c_own ? rows - lo : w;
    for (int s0 = threadIdx.x; s0 < w; s0 += kStep) {
      T wh[R], th[R], vv[R];
      bool on[R];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int s = s0 + q * kBlock;
        const long long m = i0 + lo + s;
        on[q] = s < w && (s < own0 || s >= own1);
        wh[q] = on[q] ? vec_at<T, S>(g.w, g.w_lo, g.w_hi, 0, m, g.n, g.h2)
                      : T(0);
        th[q] = on[q] ? vec_at<T, S>(g.t, g.t_lo, g.t_hi, 0, m, g.n, g.h2)
                      : T(0);
        vv[q] = T(0);
      }
      for (int b = 0; b < nb; ++b) {
        const int d = dt[b];
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const int s = s0 + q * kBlock;
          if (on[q])
            vv[q] = vv[q] + band_row<T, S, Ext>(g.bands, b, i0 + lo + s, g.n,
                                                g.ldo, g.oext) *
                                Z[lo + s + d];
        }
      }
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int s = s0 + q * kBlock;
        if (!on[q]) continue;
        const T y = wh[q] - al * Z[lo + s + dt[nb]];
        dst[s] = y - om * (th[q] - al * vv[q]);
      }
    }
  }
  // ... and on the own rows, with every other update and the stores
  {
    const int *dt = win.dtab + win.c_own * (nb + 1);
    for (int t0 = threadIdx.x; t0 < rows; t0 += kStep) {
      if (t0 != static_cast<int>(threadIdx.x)) load_own(t0);
      T vv[R];
#pragma unroll
      for (int q = 0; q < R; ++q) vv[q] = T(0);
      for (int b = 0; b < nb; ++b) {
        const S *band = g.bands + b * g.ldo + i0 + g.oext;
        const int d = dt[b];
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const int t = t0 + q * kBlock;
          if (t < rows) vv[q] = vv[q] + up<T>(band[t]) * Z[t + d];
        }
      }
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int t = t0 + q * kBlock;
        if (t >= rows) continue;
        const long long i = i0 + t;
        const T zi = Z[win.o2 + t], vi = vv[q];
        const T p = rv[q] + be * pv[q];
        const T s = wv[q] + be * av[q];
        const T qq = rv[q] - al * s;
        const T y = wv[q] - al * zi;
        const T r2 = qq - om * y;
        const T w2 = y - om * (tv[q] - al * vi);
        const T a2 = s - om * zi;
        const T c2 = zi - om * vi;
        W[win.o1 + t] = w2;
        R2[t] = r2;
        A2[t] = a2;
        C2[t] = c2;
        g.xo[i] = xv[q] + al * p + om * qq;
        g.ro[i] = Store<S>::of(r2);
        g.wo[i] = Store<S>::of(w2);
        g.pao[i] = Store<S>::of(p - om * s);
        g.ao[i] = Store<S>::of(a2);
        g.co[i] = Store<S>::of(c2);
      }
    }
  }

  __syncthreads();

  // phase 3: t' = A w' on the own rows, its store and the Gram terms
  T acc[kBicgCols];
#pragma unroll
  for (int k = 0; k < kBicgCols; ++k) acc[k] = T(0);
  const int nv = static_cast<int>(
      max(0LL, min(static_cast<long long>(rows), g.n_valid - i0)));
  for (int t0 = threadIdx.x; t0 < rows; t0 += kStep) {
    T hv[R], cs[R], tt[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int t = t0 + q * kBlock;
      hv[q] = t < nv ? up<T>(g.rh[i0 + t]) : T(0);
      cs[q] = t < nv ? g.csum[i0 + t] : T(0);
      tt[q] = T(0);
    }
    for (int b = 0; b < nb; ++b) {
      const S *band = g.bands + b * g.ldo + i0 + g.oext;
      const int d = win.wtab[b];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int t = t0 + q * kBlock;
        if (t < rows) tt[q] = tt[q] + up<T>(band[t]) * W[t + d];
      }
    }
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int t = t0 + q * kBlock;
      if (t >= rows) continue;
      const T t2 = tt[q];
      g.to[i0 + t] = Store<S>::of(t2);
      if (t >= nv) continue;
      const T w2 = W[win.o1 + t];
      const T C[6] = {R2[t], w2, t2, A2[t], C2[t], hv[q]};
      int k = 0;
#pragma unroll
      for (int p0 = 0; p0 < 6; ++p0)
#pragma unroll
        for (int q0 = p0; q0 < 6; ++q0) acc[k++] += C[p0] * C[q0];
      acc[kGramCols] += t2;
      acc[kGramCols + 1] += cs[q] * w2;
    }
  }
  block_reduce<T, kBicgCols>(acc);
  // (nblk, 22) CTA rows, then (ngroups, 22) group rows
  if (threadIdx.x == 0) {
    T *out = g.partials + static_cast<long long>(blockIdx.x) * kBicgPartials;
#pragma unroll
    for (int k = 0; k < kGramCols; ++k) out[k] = acc[k];
    out[kGramCols] = acc[kGramCols] - acc[kGramCols + 1];
  }
  T v[kBicgPartials];
  if (finish_rows<T, kBicgPartials>(
          g.partials,
          g.partials + static_cast<long long>(g.nblk) * kBicgPartials,
          g.tickets, g.nblk, v)) {
    if (threadIdx.x == 0) {
      int k = 0;
      for (int p0 = 0; p0 < 6; ++p0)
        for (int q0 = p0; q0 < 6; ++q0, ++k) {
          g.gram[p0 * 6 + q0] = v[k];
          g.gram[q0 * 6 + p0] = v[k];
        }
      g.gram[36] = v[kGramCols];
      for (int q0 = 1; q0 < 6; ++q0) g.gram[36 + q0] = T(0);
    }
  }
}

template <typename T, typename S, bool Ext, int NB>
static int launch_bicg_nb(const BicgArgs<T, S> &g, int smem, cudaStream_t st) {
  static int granted[kMaxDevices] = {};
  const int e = set_smem(reinterpret_cast<const void *>(
                             pipebicgstab_sweep_kernel<T, S, Ext, NB>),
                         smem, granted);
  if (e) return e;
  pipebicgstab_sweep_kernel<T, S, Ext, NB><<<g.nblk, kBlock, smem, st>>>(g);
  return 0;
}

// the tridiagonal and 5-point operators get their own instantiations
template <typename T, typename S, bool Ext>
int launch_bicg(const BicgArgs<T, S> &g, int smem, cudaStream_t st) {
  switch (g.offs.nb) {
    case 3: return launch_bicg_nb<T, S, Ext, 3>(g, smem, st);
    case 5: return launch_bicg_nb<T, S, Ext, 5>(g, smem, st);
    default: return launch_bicg_nb<T, S, Ext, 0>(g, smem, st);
  }
}

}  // namespace rt

extern "C" int rt_pipebicgstab_fused(
    int acc, int sto, const int *offsets, int nb, long long n,
    const void *bands, int oext, const void *csum, const void *x,
    const void *r, const void *w, const void *t, const void *pa,
    const void *a, const void *c, const void *r_hat, const void *w_lo,
    const void *w_hi, const void *t_lo, const void *t_hi, const void *c_lo,
    const void *c_hi, int h2, long long n_valid, const void *alpha,
    const void *beta, const void *omega, void *xo, void *ro, void *wo,
    void *to, void *pao, void *ao, void *co, const void *plan, int plan_len,
    int tile, int smem, void *partials, int nblk, void *tickets, void *gram,
    void *stream) {
  using namespace rt;
  if (nb < 1 || nb > kMaxBands || n < 1 || tile < 1 ||
      nblk != (n + tile - 1) / tile || h2 < 0 || oext < 0 || plan_len < 8 ||
      smem < 0 || smem > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  Offsets offs{};
  offs.nb = nb;
  for (int b = 0; b < nb; ++b) offs.off[b] = offsets[b];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = with_types(acc, sto, [&](auto ta, auto ts) -> int {
    using T = typename decltype(ta)::type;
    using S = typename decltype(ts)::type;
    BicgArgs<T, S> g{};
    g.offs = offs;
    g.n = n;
    g.n_valid = n_valid;
    g.ldo = n + 2LL * oext;
    g.oext = oext;
    g.h2 = h2;
    g.nblk = nblk;
    g.tile = tile;
    g.plan_len = plan_len;
    g.plan = static_cast<const int *>(plan);
    g.bands = static_cast<const S *>(bands);
    g.csum = static_cast<const T *>(csum);
    g.x = static_cast<const T *>(x);
    g.r = static_cast<const S *>(r);
    g.w = static_cast<const S *>(w);
    g.t = static_cast<const S *>(t);
    g.pa = static_cast<const S *>(pa);
    g.a = static_cast<const S *>(a);
    g.c = static_cast<const S *>(c);
    g.rh = static_cast<const S *>(r_hat);
    g.w_lo = static_cast<const S *>(w_lo);
    g.w_hi = static_cast<const S *>(w_hi);
    g.t_lo = static_cast<const S *>(t_lo);
    g.t_hi = static_cast<const S *>(t_hi);
    g.c_lo = static_cast<const S *>(c_lo);
    g.c_hi = static_cast<const S *>(c_hi);
    g.alpha = static_cast<const T *>(alpha);
    g.beta = static_cast<const T *>(beta);
    g.omega = static_cast<const T *>(omega);
    g.xo = static_cast<T *>(xo);
    g.ro = static_cast<S *>(ro);
    g.wo = static_cast<S *>(wo);
    g.to = static_cast<S *>(to);
    g.pao = static_cast<S *>(pao);
    g.ao = static_cast<S *>(ao);
    g.co = static_cast<S *>(co);
    g.partials = static_cast<T *>(partials);
    g.gram = static_cast<T *>(gram);
    g.tickets = static_cast<unsigned int *>(tickets);
    return oext > 0 ? launch_bicg<T, S, true>(g, smem, st)
                    : launch_bicg<T, S, false>(g, smem, st);
  });
  if (rc) return rc;
  return static_cast<int>(cudaGetLastError());
}
