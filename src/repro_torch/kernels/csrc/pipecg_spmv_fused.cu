// One whole Jacobi-preconditioned PIPECG iteration in one sweep.
//
// Replaces the Pallas TPU kernel
// repro/kernels/pipecg_spmv_fused.py::pipecg_spmv_fused (its _sweep /
// _kernel).  Per right-hand side j and row i it computes
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
// * Halo recompute straight from device memory.  w'[i] needs u' on rows
//   i + off_b, each of which needs s' and so p' on rows i + off_b + off_c.
//   Each thread recomputes that chain for its own row (n_bands^2 p' terms)
//   instead of staging a +-2h tile in shared memory, so a wide halo (the
//   2-D Laplacian's h = nx) costs no shared memory and puts no floor on the
//   tile; neighbouring threads read neighbouring rows and L1/L2 catch the
//   reuse.  Every thread evaluates a row's chain with the same operations
//   in the same order, so u' feeding w' equals the stored u'.
// * No padded copies.  Rows of u and p outside [0, n) come from optional
//   strips (k, 2h) to the left and right (null: zero); the operator is
//   zero outside [0, n).  Rows >= n_valid are masked out of the partials.
//   That is the sharded per-rank sweep's interface too.
// * Outputs go to fresh buffers: u and p are read with a +-2h halo across
//   CTAs, so updating them in place would race with a neighbour's reads.
// * Cross-block sums: per-CTA partials (k, n_blocks, 6), then a fixed-order
//   second kernel; no float atomics, so results repeat bit for bit.
// * Dtypes: arithmetic in the accumulator T (x's dtype); r, u, p and the
//   operator may be stored narrower (S = bf16 or fp8 e4m3).  Loads widen,
//   and only the r', u', p' stores narrow.
// * alpha and beta are read from (k,) device arrays: no host sync.
#include "common.cuh"

namespace rt {

template <typename T, typename S> struct SweepArgs {
  Offsets offs;
  long long n, n_valid;
  int h2, nblk;
  const S *bands, *invd, *csum;
  const T *x;
  const S *r, *u, *p;
  const S *u_lo, *u_hi, *p_lo, *p_hi;
  const T *alpha, *beta;
  T *xo;
  S *ro, *uo, *po;
  T *partials;
};

// row m of a carried vector: local rows, else the strips, else zero
template <typename T, typename S>
__device__ __forceinline__ T vec_at(const S *v, const S *lo, const S *hi,
                                    long long j, long long m, long long n,
                                    int h2) {
  if (m >= 0 && m < n) return up<T>(v[j * n + m]);
  if (m < 0) return (lo != nullptr && m >= -h2) ? up<T>(lo[j * h2 + m + h2])
                                                : T(0);
  return (hi != nullptr && m < n + h2) ? up<T>(hi[j * h2 + (m - n)]) : T(0);
}

template <typename T, typename S> struct Row {
  const SweepArgs<T, S> &a;
  long long j;
  T alpha, beta;

  __device__ T band(int b, long long m) const {
    return (m >= 0 && m < a.n) ? up<T>(a.bands[b * a.n + m]) : T(0);
  }
  __device__ T invd(long long m) const {
    return (m >= 0 && m < a.n) ? up<T>(a.invd[m]) : T(0);
  }
  __device__ T u(long long m) const {
    return vec_at<T, S>(a.u, a.u_lo, a.u_hi, j, m, a.n, a.h2);
  }
  __device__ T p2(long long m) const {  // p' = u + beta p
    return u(m) + beta * vec_at<T, S>(a.p, a.p_lo, a.p_hi, j, m, a.n, a.h2);
  }
  __device__ T s2(long long m) const {  // s' = A p'
    T s = T(0);
    for (int b = 0; b < a.offs.nb; ++b) s = s + band(b, m) * p2(m + a.offs.off[b]);
    return s;
  }
  __device__ T u2(long long m, T s) const {  // u' = u - alpha diag^-1 s'
    return u(m) - alpha * (invd(m) * s);
  }
};

template <typename T, typename S>
__global__ void pipecg_spmv_fused_kernel(const SweepArgs<T, S> a) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long j = blockIdx.y;
  const Row<T, S> row{a, j, a.alpha[j], a.beta[j]};
  // ru, wu, rr, rw, ww, sum w', sum c u'
  T v[7];
#pragma unroll
  for (int c = 0; c < 7; ++c) v[c] = T(0);
  if (i < a.n) {
    const T p2i = row.p2(i);
    const T s2i = row.s2(i);
    const T u2i = row.u2(i, s2i);
    T w2 = T(0);
    for (int b = 0; b < a.offs.nb; ++b) {
      const long long m = i + a.offs.off[b];
      const T um = (m == i) ? u2i : row.u2(m, row.s2(m));
      w2 = w2 + row.band(b, i) * um;
    }
    const long long idx = j * a.n + i;
    const T x2 = a.x[idx] + row.alpha * p2i;
    const T r2 = up<T>(a.r[idx]) - row.alpha * s2i;
    a.xo[idx] = x2;
    a.ro[idx] = Store<S>::of(r2);
    a.uo[idx] = Store<S>::of(u2i);
    a.po[idx] = Store<S>::of(p2i);
    if (i < a.n_valid) {
      v[0] = r2 * u2i;
      v[1] = w2 * u2i;
      v[2] = r2 * r2;
      v[3] = r2 * w2;
      v[4] = w2 * w2;
      v[5] = w2;
      v[6] = up<T>(a.csum[i]) * u2i;
    }
  }
  block_reduce<T, 7>(v);
  if (threadIdx.x == 0) {
    T *out = a.partials + (j * a.nblk + blockIdx.x) * 6;
#pragma unroll
    for (int c = 0; c < 5; ++c) out[c] = v[c];
    out[5] = v[5] - v[6];
  }
}

}  // namespace rt

extern "C" int rt_pipecg_spmv_fused(
    int acc, int sto, const int *offsets, int nb, long long n, int k,
    const void *bands, const void *inv_diag,
    const void *csum, const void *x, const void *r, const void *u,
    const void *p, const void *u_lo, const void *u_hi, const void *p_lo,
    const void *p_hi, int h2, long long n_valid, const void *alpha,
    const void *beta, void *xo, void *ro, void *uo, void *po, void *partials,
    int nblk, void *red, void *stream) {
  using namespace rt;
  if (nb < 1 || nb > kMaxBands || n < 1 || k < 1 || k > 65535 ||
      nblk != blocks_for(n) || h2 < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Offsets offs{};
  offs.nb = nb;
  for (int b = 0; b < nb; ++b) offs.off[b] = offsets[b];
  const dim3 grid(static_cast<unsigned>(nblk), k);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = with_types(acc, sto, [&](auto ta, auto ts) -> int {
    using T = typename decltype(ta)::type;
    using S = typename decltype(ts)::type;
    SweepArgs<T, S> a{};
    a.offs = offs;
    a.n = n;
    a.n_valid = n_valid;
    a.h2 = h2;
    a.nblk = nblk;
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
    pipecg_spmv_fused_kernel<T, S><<<grid, kBlock, 0, st>>>(a);
    reduce_rows_kernel<T, 6><<<k, kBlock, 0, st>>>(
        static_cast<const T *>(partials), static_cast<T *>(red), nblk);
    return 0;
  });
  if (rc) return rc;
  return static_cast<int>(cudaGetLastError());
}
