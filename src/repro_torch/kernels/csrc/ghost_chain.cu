// Depth-l ghost basis and its Gram matrix in one sweep.
//
// Replaces the Pallas TPU kernels
// repro/kernels/pipecg_spmv_fused.py::ghost_chain_fused and its per-rank
// form ::ghost_chain_halo, which share one _chain_sweep / _chain_kernel
// there as they share this kernel here.  With A~ = A / theta it computes
// the (2l+1, n) basis
//
//   C = [p, A~p, ..., A~^l p, r, A~r, ..., A~^(l-1) r]
//
// and its (2l+1, 2l+1) Gram matrix G = C C^T, the one reduction payload
// of a depth-l block.  Per row a link is zero, then + band_k * (previous
// link at row + off_k) in band order, then * (1/theta): the order of the
// plain version, so kernel and plain version agree bit for bit.
//
// Bound on the H100: bytes.  Per row the sweep must read p, r and the
// n_bands band values once and write the 2l+1 chain rows: 2 + n_bands +
// 2l + 1 words, 10 for the tridiagonal operator at l = 2, 14 at l = 4.
// The arithmetic is (2l - 1)(2 n_bands + 1) flops per row for the links
// and (2l+1)(2l+2) for the Gram, far below the card's ridge point.
//
// Design.
// * A tile of rows per CTA (the wrapper's CHAIN_TILE = 1024, 2048 when
//   the reach l*h exceeds 512), computed link by link over a window that starts l*h rows beyond
//   the tile on each side and shrinks by h per link, in two ping-pong
//   buffers.  Link j of a row needs link j-1 on its neighbour rows, so the
//   per-thread recompute of the earlier sweeps (n_bands^l terms per row)
//   is replaced by one pass per link over the window.  The r chain runs
//   to depth l-1 and starts (l-1)*h rows out.  Each link's tile rows are
//   stored to C (narrowed) and kept in a (2l+1, tile) block at the
//   accumulator dtype, from which the Gram is taken: G is the Gram of the
//   chain before the store narrows it, as on the TPU.
// * The workspace (two windows and the link block) lives in dynamic
//   shared memory when it fits the 227 KB a CTA may opt into (ex23 and
//   glen at l <= 8, laplacian_2d(1448, 1448) at l = 2 with 2048-row
//   tiles); otherwise the same code runs on a per-CTA slice of a global
//   scratch the wrapper allocates, so every shape the JAX package accepts
//   runs.  __syncthreads() orders both between links.
// * No padded copies.  Rows of p and r outside [0, n) come from optional
//   (l*h,) strips to the left and right (null: zero).  The bands hold the
//   operator rows [-oext, n + oext) and read as zero beyond them: the
//   single-device sweep passes oext = 0, the per-rank sweep oext = l*h
//   with the neighbours' rows; the extension is a template flag (Ext), as
//   in the other sweeps.  Rows >= n_valid are masked out of the Gram.
// * Cross-block sums: each CTA writes its m(m+1)/2 unique Gram entries to
//   (m(m+1)/2, n_blocks) scratch; a second kernel with one CTA per entry
//   sums each contiguous row in a fixed order and fills the symmetric
//   matrix.  No float atomics, so results repeat bit for bit.
// * Dtypes: links and Gram in the accumulator T (f32/f64); p, r, the
//   bands and C may be stored narrower (bf16, fp8 e4m3).  Loads widen,
//   only the C store narrows.  1/theta is read from a device scalar: no
//   host sync.
#include "common.cuh"

namespace rt {

template <typename T, typename S> struct ChainArgs {
  Offsets offs;
  long long n, n_valid;
  long long ldo;  // operator row stride, n + 2 oext
  int oext, l, h, hs, tile, m, npairs, nblk;
  long long ws;   // workspace words per CTA
  const S *bands;
  const S *p, *r;
  const S *p_lo, *p_hi, *r_lo, *r_hi;
  const T *th_inv;
  S *chain;       // (m, n)
  T *partials;    // (npairs, nblk)
  T *scratch;     // nblk * ws words, or null: dynamic shared memory
};

// upper-triangle entry k of an m x m matrix, row-major: (row, col)
__device__ __forceinline__ int2 pair_of(int k, int m) {
  int p0 = 0, first = 0;  // first: index of entry (p0, p0)
  while (k >= first + m - p0) first += m - p0++;
  return make_int2(p0, p0 + (k - first));
}

template <typename T, typename S, bool Ext>
__device__ __forceinline__ T band_at(const ChainArgs<T, S> &a, int k,
                                     long long g) {
  if constexpr (Ext)
    return (g >= -a.oext && g < a.n + a.oext)
               ? up<T>(a.bands[k * a.ldo + g + a.oext]) : T(0);
  else
    return (g >= 0 && g < a.n) ? up<T>(a.bands[k * a.n + g]) : T(0);
}

constexpr int kPairChunk = 8;

template <typename T, typename S, bool Ext>
__global__ void ghost_chain_kernel(const ChainArgs<T, S> a) {
  extern __shared__ __align__(16) unsigned char dyn[];
  T *ws = a.scratch != nullptr ? a.scratch + blockIdx.x * a.ws
                               : reinterpret_cast<T *>(dyn);
  const int H = a.l * a.h;
  const int wmax = a.tile + 2 * H;
  T *buf[2] = {ws, ws + wmax};
  T *links = ws + 2 * wmax;  // (m, tile) at the accumulator dtype
  const long long base = static_cast<long long>(blockIdx.x) * a.tile;
  const long long rows = min(static_cast<long long>(a.tile), a.n - base);
  const T thi = *a.th_inv;

  for (int c = 0; c < 2; ++c) {  // the p chain, then the r chain
    const S *v = c ? a.r : a.p;
    const S *lo = c ? a.r_lo : a.p_lo;
    const S *hi = c ? a.r_hi : a.p_hi;
    const int depth = c ? a.l - 1 : a.l;
    const int reach = depth * a.h;
    const int row0 = c ? a.l + 1 : 0;
    // link 0 over rows [base - reach, base + tile + reach)
    const int w0 = a.tile + 2 * reach;
    for (int q = threadIdx.x; q < w0; q += blockDim.x) {
      const T val = vec_at<T, S>(v, lo, hi, 0, base - reach + q, a.n, a.hs);
      buf[0][q] = val;
      const int t = q - reach;
      if (t >= 0 && t < a.tile) {
        links[row0 * a.tile + t] = val;
        if (t < rows) a.chain[row0 * a.n + base + t] = Store<S>::of(val);
      }
    }
    __syncthreads();
    for (int j = 1; j <= depth; ++j) {
      const T *prev = buf[(j - 1) & 1];
      T *cur = buf[j & 1];
      const int rj = reach - j * a.h;  // rows left beyond the tile
      const int wj = a.tile + 2 * rj;
      for (int q = threadIdx.x; q < wj; q += blockDim.x) {
        const long long g = base - rj + q;
        T s = T(0);
        for (int k = 0; k < a.offs.nb; ++k)
          s = s + band_at<T, S, Ext>(a, k, g) * prev[q + a.h + a.offs.off[k]];
        const T val = s * thi;
        cur[q] = val;
        const int t = q - rj;
        if (t >= 0 && t < a.tile) {
          links[(row0 + j) * a.tile + t] = val;
          if (t < rows)
            a.chain[(row0 + j) * a.n + base + t] = Store<S>::of(val);
        }
      }
      __syncthreads();
    }
  }

  // Gram partials of the tile rows below n_valid, kPairChunk entries per
  // block reduction
  const long long nv = max(0LL, min(static_cast<long long>(a.tile),
                                    a.n_valid - base));
  for (int k0 = 0; k0 < a.npairs; k0 += kPairChunk) {
    T acc[kPairChunk];
#pragma unroll
    for (int c = 0; c < kPairChunk; ++c) {
      acc[c] = T(0);
      if (k0 + c < a.npairs) {
        const int2 ij = pair_of(k0 + c, a.m);
        const T *ci = links + ij.x * a.tile;
        const T *cj = links + ij.y * a.tile;
        for (long long t = threadIdx.x; t < nv; t += blockDim.x)
          acc[c] = acc[c] + ci[t] * cj[t];
      }
    }
    block_reduce<T, kPairChunk>(acc);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int c = 0; c < kPairChunk; ++c)
        if (k0 + c < a.npairs)
          a.partials[static_cast<long long>(k0 + c) * a.nblk + blockIdx.x] =
              acc[c];
    }
  }
}

// CTA k sums row k of the (npairs, nblk) partials in a fixed order and
// writes Gram entries (p, q) and (q, p)
template <typename T>
__global__ void finish_chain_gram_kernel(const T *__restrict__ partials,
                                         T *__restrict__ gram, int nblk,
                                         int m) {
  const int k = blockIdx.x;
  const T *row = partials + static_cast<long long>(k) * nblk;
  T v[1] = {T(0)};
  for (int b = threadIdx.x; b < nblk; b += blockDim.x) v[0] += row[b];
  block_reduce<T, 1>(v);
  if (threadIdx.x != 0) return;
  const int2 ij = pair_of(k, m);
  gram[ij.x * m + ij.y] = v[0];
  gram[ij.y * m + ij.x] = v[0];
}

template <typename T, typename S, bool Ext>
int launch_chain(const ChainArgs<T, S> &g, cudaStream_t st) {
  size_t smem = 0;
  if (g.scratch == nullptr) {
    smem = static_cast<size_t>(g.ws) * sizeof(T);
    const cudaError_t e = cudaFuncSetAttribute(
        ghost_chain_kernel<T, S, Ext>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ghost_chain_kernel<T, S, Ext><<<g.nblk, kBlock, smem, st>>>(g);
  return 0;
}

}  // namespace rt

extern "C" int rt_ghost_chain(
    int acc, int sto, const int *offsets, int nb, long long n, int l,
    const void *bands, int oext, const void *p, const void *r,
    const void *p_lo, const void *p_hi, const void *r_lo, const void *r_hi,
    int hs, long long n_valid, const void *th_inv, void *chain, int tile,
    void *scratch, long long ws, void *partials, int nblk, void *gram,
    void *stream) {
  using namespace rt;
  int h = 0;
  for (int b = 0; b < nb && nb <= kMaxBands; ++b) {
    const int o = offsets[b] < 0 ? -offsets[b] : offsets[b];
    h = o > h ? o : h;
  }
  const int m = 2 * l + 1;
  if (nb < 1 || nb > kMaxBands || n < 1 || l < 1 || tile < 1 ||
      nblk != (n + tile - 1) / tile || oext < 0 || hs < 0 ||
      ws < 2LL * (tile + 2LL * l * h) + static_cast<long long>(m) * tile)
    return static_cast<int>(cudaErrorInvalidValue);
  Offsets offs{};
  offs.nb = nb;
  for (int b = 0; b < nb; ++b) offs.off[b] = offsets[b];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int npairs = m * (m + 1) / 2;
  const int rc = with_types(acc, sto, [&](auto ta, auto ts) -> int {
    using T = typename decltype(ta)::type;
    using S = typename decltype(ts)::type;
    ChainArgs<T, S> g{};
    g.offs = offs;
    g.n = n;
    g.n_valid = n_valid;
    g.ldo = n + 2LL * oext;
    g.oext = oext;
    g.l = l;
    g.h = h;
    g.hs = hs;
    g.tile = tile;
    g.m = m;
    g.npairs = npairs;
    g.nblk = nblk;
    g.ws = ws;
    g.bands = static_cast<const S *>(bands);
    g.p = static_cast<const S *>(p);
    g.r = static_cast<const S *>(r);
    g.p_lo = static_cast<const S *>(p_lo);
    g.p_hi = static_cast<const S *>(p_hi);
    g.r_lo = static_cast<const S *>(r_lo);
    g.r_hi = static_cast<const S *>(r_hi);
    g.th_inv = static_cast<const T *>(th_inv);
    g.chain = static_cast<S *>(chain);
    g.partials = static_cast<T *>(partials);
    g.scratch = static_cast<T *>(scratch);
    const int e = oext > 0 ? launch_chain<T, S, true>(g, st)
                           : launch_chain<T, S, false>(g, st);
    if (e) return e;
    finish_chain_gram_kernel<T><<<npairs, kBlock, 0, st>>>(
        static_cast<const T *>(partials), static_cast<T *>(gram), nblk, m);
    return 0;
  });
  if (rc) return rc;
  return static_cast<int>(cudaGetLastError());
}
