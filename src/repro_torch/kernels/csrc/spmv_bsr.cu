// Blocked-ELL (BSR) SpMV and one whole Jacobi-preconditioned PIPECG
// iteration on a BSR operator.
//
// Replaces the Pallas TPU kernels repro/kernels/spmv_bsr.py::spmv_bsr and
// ::pipecg_bsr_fused.  The operator is a BsrMatrix: block row br stores deg
// (block column idx[br, d], dense bs x bs block blk[br, d]) pairs, pads being
// self-pointing zero blocks, so every gather stays inside the matrix.
//
// spmv_bsr: y[j, br*bs + i] = sum_d sum_c blk[br, d, i, c] x[j, idx[br, d]*bs + c].
// Bound on the H100: bytes.  Per row it must read deg*bs block values,
// deg/bs indices and one x value and write one y value (22.75 words per
// row for ex23 at bs = 4, 31.25 for the 5-point 2-D Laplacian); 2 deg bs
// flops per row.  Design: one thread per row, bs neighbouring threads per
// block row, so a warp reads 32/bs consecutive block rows' blocks; the
// gathered x blocks come from L1/L2.  The terms are added in d, then c
// order from zero, the order of the plain version, and the build turns FMA
// contraction off, so kernel and plain version agree bit for bit.
//
// pipecg_bsr_fused: per right-hand side j
//
//   p' = u + beta p          s' = A p'          q' = diag^-1 s'
//   x' = x + alpha p'        r' = r - alpha s'  u' = u - alpha q'
//   w' = A u'
//
// and the reduction row <r',u'>, <w',u'>, <r',r'>, <r',w'>, <w',w'>,
// sum(w') - sum(c u') (c = A^T 1), the DIA sweep's row layout.  Only x, r,
// u and p are written; s, q and w never reach device memory.  Bound on
// the H100: bytes, 10 vectors + blocks + indices per row (the reference's
// count, BsrMatrix.words_per_iter).
//
// Design (simple and right first).  w' at block row br needs u' at every
// block column cb = idx[br, d], and u' there needs s' = A p' at cb: the
// two-level gather idx[idx[br]] of the TPU kernel, deg^2 block GEMVs per
// block row.  A group of bs lanes (a power of two <= 32, so a group never
// straddles a warp) owns block row br; for each d, lane l computes s' and
// u' at row l of block column cb (recomputing p' = u + beta p from u and p
// in device memory), and the group swaps those bs values by warp shuffle
// to form its rows of w'.  Every lane evaluates s' at a row with the same
// operations in the same order, so the u' that feeds w' equals the stored
// u'.  The cost is that a neighbour block row's blocks are read deg times,
// from L1/L2 where they are still there: the sweep sits above its bound.
// Outputs go to fresh buffers (u and p are read across CTAs); cross-block
// sums are per-CTA partials finished by reduce_rows_kernel in a fixed
// order (no float atomics).  alpha and beta are read from (k,) device
// arrays: no host sync.
#include "common.cuh"

namespace rt {

template <typename T>
__global__ void spmv_bsr_kernel(const int *__restrict__ idx,
                                const T *__restrict__ blk,
                                const T *__restrict__ x, T *__restrict__ y,
                                long long nbr, int deg, int bs) {
  const long long n = nbr * bs;
  const long long row = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  if (row >= n) return;
  const long long br = row / bs;
  const int i = static_cast<int>(row - br * bs);
  const T *xj = x + static_cast<long long>(blockIdx.y) * n;
  T acc = T(0);
  for (int d = 0; d < deg; ++d) {
    const long long c0 = static_cast<long long>(idx[br * deg + d]) * bs;
    const T *b = blk + ((br * deg + d) * bs + i) * bs;
    for (int c = 0; c < bs; ++c) acc = acc + b[c] * xj[c0 + c];
  }
  y[static_cast<long long>(blockIdx.y) * n + row] = acc;
}

template <typename T> struct BsrArgs {
  long long nbr, n;
  int deg, bs, nblk;
  const int *idx;
  const T *blk, *invd, *csum, *x, *r, *u, *p, *alpha, *beta;
  T *xo, *ro, *uo, *po, *partials;
};

// s' = A p' at row `lane` of block row cb, p' = u + beta p recomputed
template <typename T>
__device__ __forceinline__ T s2_at(const BsrArgs<T> &a, const T *uj,
                                   const T *pj, long long cb, int lane,
                                   T beta) {
  T s = T(0);
  for (int e = 0; e < a.deg; ++e) {
    const long long c0 = static_cast<long long>(a.idx[cb * a.deg + e]) * a.bs;
    const T *b = a.blk + ((cb * a.deg + e) * a.bs + lane) * a.bs;
    for (int c = 0; c < a.bs; ++c) s = s + b[c] * (uj[c0 + c] + beta * pj[c0 + c]);
  }
  return s;
}

template <typename T>
__global__ void pipecg_bsr_fused_kernel(const BsrArgs<T> a) {
  const long long row = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  const long long j = blockIdx.y;
  const int bs = a.bs;
  const long long br = row / bs;  // kBlock % bs == 0: groups stay in a CTA
  // ru, wu, rr, rw, ww, sum w', sum c u'
  T v[7];
#pragma unroll
  for (int c = 0; c < 7; ++c) v[c] = T(0);
  if (br < a.nbr) {
    const int lane = static_cast<int>(row - br * bs);
    const int wl = threadIdx.x & 31;
    const unsigned group = (bs == 32 ? 0xffffffffu : ((1u << bs) - 1u))
                           << (wl & ~(bs - 1));
    const T alpha = a.alpha[j], beta = a.beta[j];
    const T *uj = a.u + j * a.n;
    const T *pj = a.p + j * a.n;
    const T s2i = s2_at(a, uj, pj, br, lane, beta);
    const T p2i = uj[row] + beta * pj[row];
    const T u2i = uj[row] - alpha * (a.invd[row] * s2i);
    T w2 = T(0);
    for (int d = 0; d < a.deg; ++d) {
      const long long cb = a.idx[br * a.deg + d];
      const long long m = cb * bs + lane;
      const T um = uj[m] - alpha * (a.invd[m] * s2_at(a, uj, pj, cb, lane, beta));
      const T *b = a.blk + ((br * a.deg + d) * bs + lane) * bs;
      for (int c = 0; c < bs; ++c)
        w2 = w2 + b[c] * __shfl_sync(group, um, c, bs);
    }
    const long long at = j * a.n + row;
    const T x2 = a.x[at] + alpha * p2i;
    const T r2 = a.r[at] - alpha * s2i;
    a.xo[at] = x2;
    a.ro[at] = r2;
    a.uo[at] = u2i;
    a.po[at] = p2i;
    v[0] = r2 * u2i;
    v[1] = w2 * u2i;
    v[2] = r2 * r2;
    v[3] = r2 * w2;
    v[4] = w2 * w2;
    v[5] = w2;
    v[6] = a.csum[row] * u2i;
  }
  block_reduce<T, 7>(v);
  if (threadIdx.x == 0) {
    T *out = a.partials + (j * a.nblk + blockIdx.x) * 6;
#pragma unroll
    for (int c = 0; c < 5; ++c) out[c] = v[c];
    out[5] = v[5] - v[6];
  }
}

inline bool bad_shape(long long nbr, int deg, int bs, int k) {
  return nbr < 1 || deg < 1 || bs < 1 || k < 1 || k > 65535;
}

}  // namespace rt

extern "C" int rt_spmv_bsr(int acc, long long nbr, int deg, int bs, int k,
                           const int *idx, const void *blk, const void *x,
                           void *y, void *stream) {
  using namespace rt;
  if (bad_shape(nbr, deg, bs, k)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks_for(nbr * bs)), k);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = with_accum(acc, [&](auto ta) -> int {
    using T = typename decltype(ta)::type;
    spmv_bsr_kernel<T><<<grid, kBlock, 0, st>>>(
        idx, static_cast<const T *>(blk), static_cast<const T *>(x),
        static_cast<T *>(y), nbr, deg, bs);
    return 0;
  });
  if (rc) return rc;
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_pipecg_bsr_fused(
    int acc, long long nbr, int deg, int bs, int k, const int *idx,
    const void *blk, const void *inv_diag, const void *csum, const void *x,
    const void *r, const void *u, const void *p, const void *alpha,
    const void *beta, void *xo, void *ro, void *uo, void *po, void *partials,
    int nblk, void *red, void *stream) {
  using namespace rt;
  // bs lanes per block row, swapped by warp shuffle: a power of two <= 32
  if (bad_shape(nbr, deg, bs, k) || bs > 32 || (bs & (bs - 1)) ||
      nblk != blocks_for(nbr * bs))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(nblk), k);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = with_accum(acc, [&](auto ta) -> int {
    using T = typename decltype(ta)::type;
    BsrArgs<T> a{};
    a.nbr = nbr;
    a.n = nbr * bs;
    a.deg = deg;
    a.bs = bs;
    a.nblk = nblk;
    a.idx = idx;
    a.blk = static_cast<const T *>(blk);
    a.invd = static_cast<const T *>(inv_diag);
    a.csum = static_cast<const T *>(csum);
    a.x = static_cast<const T *>(x);
    a.r = static_cast<const T *>(r);
    a.u = static_cast<const T *>(u);
    a.p = static_cast<const T *>(p);
    a.alpha = static_cast<const T *>(alpha);
    a.beta = static_cast<const T *>(beta);
    a.xo = static_cast<T *>(xo);
    a.ro = static_cast<T *>(ro);
    a.uo = static_cast<T *>(uo);
    a.po = static_cast<T *>(po);
    a.partials = static_cast<T *>(partials);
    pipecg_bsr_fused_kernel<T><<<grid, kBlock, 0, st>>>(a);
    reduce_rows_kernel<T, 6><<<k, kBlock, 0, st>>>(
        static_cast<const T *>(partials), static_cast<T *>(red), nblk);
    return 0;
  });
  if (rc) return rc;
  return static_cast<int>(cudaGetLastError());
}
