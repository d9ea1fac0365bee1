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
// Design.  w' at block row br needs u' at every block column cb =
// idx[br, d], and u' there needs s' = A p' at cb: the two-level gather
// idx[idx[br]] of the TPU kernel.  A CTA owns the contiguous range of
// kBlock / bs block rows of its kBlock rows, one row per thread and a
// group of bs lanes (a power of two <= 32, so a group never straddles a
// warp) per block row.  Phase 1: each lane computes s' at its own row
// (recomputing p' = u + beta p from u and p in device memory), then u'
// and p', writes x', r', u', p', forms the reduction terms that do not
// need w', and puts u' into a shared-memory tile of the range.
// __syncthreads().  Phase 2: lane l forms row l of w' from
// the same blocks, read again from L1, and u' at each block column: from
// the tile when cb lies in the CTA's range, else recomputed as s' at row
// l of cb and swapped across the group by warp shuffle.  All lanes of a
// group share br, so they take one branch and the shuffle's mask stays
// whole.  On a banded operator only the range's first and last block
// rows reach outside it; on the 2-D Laplacian the +-nx/bs neighbours do
// (nx/bs > kBlock/bs), 2 of 5 gathers.  Per row that is about 2 deg bs
// block loads, not deg^2 bs.  Every u' is evaluated with the same
// operations in the same order (s' over d, then c, from zero), so the u'
// read from the tile or recomputed equals the stored u' bit for bit, and
// w' is summed over d, then c, from zero, as in the plain version.  The
// kernel is instantiated per block size, so its loops unroll and a block
// row, or a gathered block of u or p, is read by 16-byte loads (blocks, u
// and p start on 16 bytes: the wrapper checks).
// Outputs go to fresh buffers (u and p are read across CTAs); cross-block
// sums are per-CTA partials finished by reduce_rows_kernel in a fixed
// order (no float atomics).  alpha and beta are read from (k,) device
// arrays: no host sync.
#include <cstdint>
#include <initializer_list>

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
  int deg, nblk;
  const int *idx;
  const T *blk, *invd, *csum, *x, *r, *u, *p, *alpha, *beta;
  T *xo, *ro, *uo, *po, *partials;
};

// n consecutive values at p (aligned to n values), by 16-byte loads where
// n allows: a block row's bs coefficients, or a vector's bs-row block
template <typename T, int N>
__device__ __forceinline__ void load_n(const T *p, T (&v)[N]) {
  if constexpr (sizeof(T) == 8 && N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const double2 t = reinterpret_cast<const double2 *>(p)[i];
      v[2 * i] = t.x;
      v[2 * i + 1] = t.y;
    }
  } else if constexpr (sizeof(T) == 4 && N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 t = reinterpret_cast<const float4 *>(p)[i];
      v[4 * i] = t.x;
      v[4 * i + 1] = t.y;
      v[4 * i + 2] = t.z;
      v[4 * i + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
}

// s' = A p' at row `lane` of block row cb, p' = u + beta p recomputed
template <typename T, int BS>
__device__ __forceinline__ T s2_at(const BsrArgs<T> &a, const T *uj,
                                   const T *pj, long long cb, int lane,
                                   T beta) {
  constexpr int CH = BS < 4 ? BS : 4;  // values read at once
  T s = T(0);
  for (int e = 0; e < a.deg; ++e) {
    const long long c0 = static_cast<long long>(a.idx[cb * a.deg + e]) * BS;
    const T *b = a.blk + ((cb * a.deg + e) * BS + lane) * BS;
#pragma unroll
    for (int c = 0; c < BS; c += CH) {
      T bv[CH], uv[CH], pv[CH];
      load_n(b + c, bv);
      load_n(uj + c0 + c, uv);
      load_n(pj + c0 + c, pv);
#pragma unroll
      for (int i = 0; i < CH; ++i) s = s + bv[i] * (uv[i] + beta * pv[i]);
    }
  }
  return s;
}

template <typename T, int BS>
__global__ void __launch_bounds__(kBlock)
pipecg_bsr_fused_kernel(const BsrArgs<T> a) {
  constexpr int CH = BS < 4 ? BS : 4;
  __shared__ T su[kBlock];  // u' of the CTA's rows
  const long long row0 = static_cast<long long>(blockIdx.x) * kBlock;
  const long long row = row0 + threadIdx.x;
  const long long j = blockIdx.y;
  const long long br = row / BS;  // kBlock % BS == 0: groups stay in a CTA
  const long long br0 = row0 / BS;  // the CTA's range of block rows
  const long long br1 = min(br0 + kBlock / BS, a.nbr);
  const bool live = br < a.nbr;
  const int lane = static_cast<int>(row - br * BS);
  const T alpha = a.alpha[j], beta = a.beta[j];
  const T *uj = a.u + j * a.n;
  const T *pj = a.p + j * a.n;
  const long long at = j * a.n + row;

  // phase 1: everything at this lane's row that does not need w'
  // ru, wu, rr, rw, ww, sum w', sum c u'
  T v[7];
#pragma unroll
  for (int c = 0; c < 7; ++c) v[c] = T(0);
  T u2i = T(0), r2 = T(0);
  if (live) {
    const T s2i = s2_at<T, BS>(a, uj, pj, br, lane, beta);
    const T p2i = uj[row] + beta * pj[row];
    u2i = uj[row] - alpha * (a.invd[row] * s2i);
    r2 = a.r[at] - alpha * s2i;
    a.xo[at] = a.x[at] + alpha * p2i;
    a.ro[at] = r2;
    a.uo[at] = u2i;
    a.po[at] = p2i;
    v[0] = r2 * u2i;
    v[2] = r2 * r2;
    v[6] = a.csum[row] * u2i;
  }
  su[threadIdx.x] = u2i;
  __syncthreads();

  // phase 2: w' = A u', u' from the tile inside the range
  if (live) {
    const int wl = threadIdx.x & 31;
    const unsigned group = (BS == 32 ? 0xffffffffu : ((1u << BS) - 1u))
                           << (wl & ~(BS - 1));
    T w2 = T(0);
    for (int d = 0; d < a.deg; ++d) {
      const long long cb = a.idx[br * a.deg + d];
      const T *b = a.blk + ((br * a.deg + d) * BS + lane) * BS;
      if (cb >= br0 && cb < br1) {  // one branch for the whole group
        const T *us = su + (cb - br0) * BS;
#pragma unroll
        for (int c = 0; c < BS; c += CH) {
          T bv[CH];
          load_n(b + c, bv);
#pragma unroll
          for (int i = 0; i < CH; ++i) w2 = w2 + bv[i] * us[c + i];
        }
      } else {
        const long long m = cb * BS + lane;
        const T um = uj[m] - alpha * (a.invd[m] *
                                      s2_at<T, BS>(a, uj, pj, cb, lane, beta));
#pragma unroll
        for (int c = 0; c < BS; c += CH) {
          T bv[CH];
          load_n(b + c, bv);
#pragma unroll
          for (int i = 0; i < CH; ++i)
            w2 = w2 + bv[i] * __shfl_sync(group, um, c + i, BS);
        }
      }
    }
    v[1] = w2 * u2i;
    v[3] = r2 * w2;
    v[4] = w2 * w2;
    v[5] = w2;
  }
  block_reduce<T, 7>(v);
  if (threadIdx.x == 0) {
    T *out = a.partials + (j * a.nblk + blockIdx.x) * 6;
#pragma unroll
    for (int c = 0; c < 5; ++c) out[c] = v[c];
    out[5] = v[5] - v[6];
  }
}

template <typename T, int BS>
void launch_bsr_fused(const BsrArgs<T> &a, int k, cudaStream_t st) {
  pipecg_bsr_fused_kernel<T, BS>
      <<<dim3(static_cast<unsigned>(a.nblk), k), kBlock, 0, st>>>(a);
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
  // blocks and vectors are read by 16-byte loads
  for (const void *q : {blk, u, p})
    if (reinterpret_cast<uintptr_t>(q) % 16)
      return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = with_accum(acc, [&](auto ta) -> int {
    using T = typename decltype(ta)::type;
    BsrArgs<T> a{};
    a.nbr = nbr;
    a.n = nbr * bs;
    a.deg = deg;
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
    switch (bs) {
      case 1: launch_bsr_fused<T, 1>(a, k, st); break;
      case 2: launch_bsr_fused<T, 2>(a, k, st); break;
      case 4: launch_bsr_fused<T, 4>(a, k, st); break;
      case 8: launch_bsr_fused<T, 8>(a, k, st); break;
      case 16: launch_bsr_fused<T, 16>(a, k, st); break;
      default: launch_bsr_fused<T, 32>(a, k, st); break;
    }
    reduce_rows_kernel<T, 6><<<k, kBlock, 0, st>>>(
        static_cast<const T *>(partials), static_cast<T *>(red), nblk);
    return 0;
  });
  if (rc) return rc;
  return static_cast<int>(cudaGetLastError());
}
