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
// * Halo recompute straight from device memory, as the PIPECG sweep
//   (csrc/pipecg_spmv_fused.cu) does.  t'[i] needs w' on rows i + off_b,
//   each of which needs v and so z on rows i + off_b + off_c: each thread
//   recomputes that chain for its own row (n_bands^2 (t, c) pairs, 9 for
//   the tridiagonal operator, 25 for the 5-band 2-D Laplacian) instead of
//   staging a +-2h tile in shared memory, which would not fit once
//   h = 1448.  Neighbouring threads read neighbouring rows and L1/L2 catch
//   the reuse.  Every thread evaluates a row's chain with the same
//   operations in the same order, so the w' that feeds t' equals the
//   stored w'.
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
// * Cross-block sums: each CTA writes its 21 unique Gram entries and its
//   checksum partial to (22, n_blocks) scratch; a second kernel with one
//   CTA per entry sums each contiguous row in a fixed order and fills the
//   symmetric (7, 6) payload.  No float atomics, so results repeat bit for
//   bit.
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
  int oext, h2, nblk;
  const S *bands;
  const T *csum;
  const T *x;
  const S *r, *w, *t, *pa, *a, *c, *rh;
  const S *w_lo, *w_hi, *t_lo, *t_hi, *c_lo, *c_hi;
  const T *alpha, *beta, *omega;
  T *xo;
  S *ro, *wo, *to, *pao, *ao, *co;
  T *partials;
};

template <typename T, typename S, bool Ext> struct BicgRow {
  const BicgArgs<T, S> &a;
  T alpha, beta, omega;

  __device__ bool op_row(long long m) const {
    if constexpr (Ext) return m >= -a.oext && m < a.n + a.oext;
    else return m >= 0 && m < a.n;
  }
  __device__ T band(int b, long long m) const {
    if constexpr (Ext)
      return op_row(m) ? up<T>(a.bands[b * a.ldo + m + a.oext]) : T(0);
    else return op_row(m) ? up<T>(a.bands[b * a.n + m]) : T(0);
  }
  __device__ T w(long long m) const {
    return vec_at<T, S>(a.w, a.w_lo, a.w_hi, 0, m, a.n, a.h2);
  }
  __device__ T t(long long m) const {
    return vec_at<T, S>(a.t, a.t_lo, a.t_hi, 0, m, a.n, a.h2);
  }
  __device__ T z(long long m) const {  // z = t + beta c
    return t(m) + beta * vec_at<T, S>(a.c, a.c_lo, a.c_hi, 0, m, a.n, a.h2);
  }
  __device__ T v(long long m) const {  // v = A z
    T s = T(0);
    for (int b = 0; b < a.offs.nb; ++b)
      s = s + band(b, m) * z(m + a.offs.off[b]);
    return s;
  }
  // w' = (w - alpha z) - omega (t - alpha v) on row m, given z and v there
  __device__ T wn(long long m, T zm, T vm) const {
    const T y = w(m) - alpha * zm;
    return y - omega * (t(m) - alpha * vm);
  }
};

template <typename T, typename S, bool Ext>
__global__ void pipebicgstab_fused_kernel(const BicgArgs<T, S> a) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const BicgRow<T, S, Ext> row{a, *a.alpha, *a.beta, *a.omega};
  T acc[kBicgCols];
#pragma unroll
  for (int k = 0; k < kBicgCols; ++k) acc[k] = T(0);
  if (i < a.n) {
    const T al = row.alpha, be = row.beta, om = row.omega;
    const T zi = row.z(i);
    const T vi = row.v(i);
    const T wi = row.w(i);
    const T ri = up<T>(a.r[i]);
    const T p = ri + be * up<T>(a.pa[i]);
    const T s = wi + be * up<T>(a.a[i]);
    const T q = ri - al * s;
    const T y = wi - al * zi;
    const T x2 = a.x[i] + al * p + om * q;
    const T r2 = q - om * y;
    const T w2 = y - om * (row.t(i) - al * vi);
    T t2 = T(0);
    for (int b = 0; b < a.offs.nb; ++b) {
      const long long m = i + a.offs.off[b];
      const T wm = (m == i) ? w2 : row.wn(m, row.z(m), row.v(m));
      t2 = t2 + row.band(b, i) * wm;
    }
    const T pa2 = p - om * s;
    const T a2 = s - om * zi;
    const T c2 = zi - om * vi;
    a.xo[i] = x2;
    a.ro[i] = Store<S>::of(r2);
    a.wo[i] = Store<S>::of(w2);
    a.to[i] = Store<S>::of(t2);
    a.pao[i] = Store<S>::of(pa2);
    a.ao[i] = Store<S>::of(a2);
    a.co[i] = Store<S>::of(c2);
    if (i < a.n_valid) {
      const T C[6] = {r2, w2, t2, a2, c2, up<T>(a.rh[i])};
      int k = 0;
#pragma unroll
      for (int p0 = 0; p0 < 6; ++p0)
#pragma unroll
        for (int q0 = p0; q0 < 6; ++q0) acc[k++] = C[p0] * C[q0];
      acc[kGramCols] = t2;
      acc[kGramCols + 1] = a.csum[i] * w2;
    }
  }
  block_reduce<T, kBicgCols>(acc);
  if (threadIdx.x == 0) {
    T *out = a.partials + blockIdx.x;  // column blockIdx.x of (22, nblk)
#pragma unroll
    for (int k = 0; k < kGramCols; ++k) out[k * a.nblk] = acc[k];
    out[kGramCols * a.nblk] = acc[kGramCols] - acc[kGramCols + 1];
  }
}

// CTA k sums row k of the (22, nblk) partials in a fixed order and writes
// its payload entries: Gram entry (p, q) and (q, p) for k < 21 in the
// kernel's upper-triangle order, the checksum row for k = 21
template <typename T>
__global__ void finish_gram_kernel(const T *__restrict__ partials,
                                   T *__restrict__ gram, int nblk) {
  const int k = blockIdx.x;
  const T *row = partials + static_cast<long long>(k) * nblk;
  T v[1] = {T(0)};
  for (int b = threadIdx.x; b < nblk; b += blockDim.x) v[0] += row[b];
  block_reduce<T, 1>(v);
  if (threadIdx.x != 0) return;
  if (k == kGramCols) {
    gram[36] = v[0];
    for (int q0 = 1; q0 < 6; ++q0) gram[36 + q0] = T(0);
    return;
  }
  int p0 = 0, first = 0;  // first: index of entry (p0, p0)
  while (k >= first + 6 - p0) first += 6 - p0++;
  const int q0 = p0 + (k - first);
  gram[p0 * 6 + q0] = v[0];
  gram[q0 * 6 + p0] = v[0];
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
    void *to, void *pao, void *ao, void *co, void *partials, int nblk,
    void *gram, void *stream) {
  using namespace rt;
  if (nb < 1 || nb > kMaxBands || n < 1 || nblk != blocks_for(n) ||
      h2 < 0 || oext < 0)
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
    if (oext > 0)
      pipebicgstab_fused_kernel<T, S, true><<<nblk, kBlock, 0, st>>>(g);
    else
      pipebicgstab_fused_kernel<T, S, false><<<nblk, kBlock, 0, st>>>(g);
    finish_gram_kernel<T><<<kBicgPartials, kBlock, 0, st>>>(
        static_cast<const T *>(partials), static_cast<T *>(gram), nblk);
    return 0;
  });
  if (rc) return rc;
  return static_cast<int>(cudaGetLastError());
}
