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
// and (2l+1)(2l+2) for the Gram, far below the card's ridge point.  So
// the design is about bytes in flight and few barriers.
//
// Design.
// * A CTA owns a tile of rows (kernels/pipecg_spmv_fused.py::chain_plan)
//   and forms the links over a window that starts H = l*h rows beyond the
//   tile on each side.  Window slot s holds row tile0 - H + s.  Every link
//   has its own buffer over the slots it needs: link j of p the slots
//   [j h, W - j h) (W = tile + 2H), link j of r the slots [(j+1) h,
//   W - (j+1) h); m tile-sized buffers plus 2 H l words in all.  No buffer
//   is overwritten, so the links of a row stay in the workspace for the
//   Gram.
// * Both chains in the same passes.  Pass 0 loads p and r over the window;
//   pass j (1 <= j < l) forms link j of both chains, pass l p's last link:
//   l + 1 passes and l barriers (pass l's values are read only by the
//   thread that formed them).
// * Fixed row ownership, batched loads.  A thread owns the window slots
//   b kStep + q kBlock + tid (q < kBatch = 4, kStep = 1024) in every pass,
//   so neighbouring threads touch neighbouring rows, and it starts all of
//   a batch's loads before the first is used; CTAs whose window lies
//   inside [0, n) load without bounds tests.  The plan sizes the tile so
//   the window fills whole batches: one batch (1020 rows at l = 2, 1016 at
//   l = 4 for a tridiagonal operator) while the reach leaves at least half
//   of it to the tile.  Then, for the tridiagonal operator at l = 2 and 4
//   (the main path's sweeps), the depth and the band count are template
//   parameters: each owned row's three band values are loaded once, in
//   pass 0, and held in registers for every link, a pass forms a row's
//   links and stores them before it reads the next row's operands, and
//   the Gram loads a row's m links once.  Other shapes take runtime loops
//   (5 bands keep a compile-time band count) that re-read the bands in
//   each pass from L2, where pass 0 fetched them.
// * Occupancy: three CTAs of 256 threads an SM at l = 2 (41 KB of shared
//   memory and at most 80 registers at float64); l = 4 holds 73 KB, so two
//   fit, and it and the runtime loops take the registers of two CTAs, so
//   no instantiation spills.
// * The Gram per row.  A thread forms the products of its own rows' links
//   into kGramGroup = 15 accumulators: all 15 pairs at l = 2, the 45 of
//   l = 4 in three groups, l = 8's 153 in eleven, so no accumulator array
//   outgrows the registers.  Rows >= n_valid are masked out.  Each group
//   is summed over the CTA by a butterfly that transposes as it reduces
//   (16 shuffles a warp; a shuffle tree a column took 75 and, at l = 4,
//   most of the kernel's issue slots) into the CTA's partial row.
// * The finish inside the launch.  The CTAs finish the partial rows
//   themselves with integer tickets, one a CTA for every pair group
//   (finish_rows' two-level order: the last CTA of each group of 32 sums
//   the group's rows while the others still run, the last group the group
//   rows) and fill the symmetric Gram.  No float atomics and no second
//   launch; the summation order depends only on n and the tile, so the
//   Gram repeats bit for bit.  The tickets are back at zero when the
//   launch ends.
// * Workspace.  Dynamic shared memory when the buffers fit the 227 KB a CTA
//   may opt into (set once per kernel, device and size: common.cuh,
//   set_smem); otherwise the same code runs on a per-CTA slice of a global
//   scratch the wrapper allocates (laplacian_2d(1448, 1448) at l = 4), so
//   every shape the JAX package accepts runs.
// * No padded copies.  Rows of p and r outside [0, n) come from optional
//   (l*h,) strips to the left and right (null: zero).  The bands hold the
//   operator rows [-oext, n + oext) and read as zero beyond them: the
//   single-device sweep passes oext = 0, the per-rank sweep oext = l*h
//   with the neighbours' rows; the extension is a template flag (Ext), as
//   in the other sweeps.
// * Dtypes: links and Gram in the accumulator T (f32/f64); p, r, the
//   bands and C may be stored narrower (bf16, fp8 e4m3).  Loads widen,
//   only the C store narrows, and the Gram is taken before it narrows.
//   theta is read from a device scalar (no host sync) or passed by value,
//   and inverted in the kernel, in IEEE division as the plain version's
//   1 / theta, so no separate launch forms the reciprocal.
#include <type_traits>

#include "common.cuh"

namespace rt {

// Gram entries one block reduction and one finish carry: a column group
// of finish_rows' wide path
constexpr int kGramGroup = 15;

template <typename T, typename S> struct ChainArgs {
  Offsets offs;
  long long n, n_valid;
  long long ldo;  // operator row stride, n + 2 oext
  int oext, l, h, hs, tile, npairs, nblk;
  long long ws;   // workspace words per CTA
  const S *bands;
  const S *p, *r;
  const S *p_lo, *p_hi, *r_lo, *r_hi;
  const T *theta;  // a device scalar, or null: theta_value
  T theta_value;
  S *chain;                // (m, n)
  T *partials;             // (pair groups, nblk + ngroups, kGramGroup)
  T *gram;                 // (m, m)
  unsigned int *tickets;   // ngroups + 1, zero
  T *scratch;              // nblk * ws words, or null: dynamic shared memory
};

// upper-triangle entry k of an m x m matrix, row-major: (row, col)
__device__ __forceinline__ int2 pair_of(int k, int m) {
  int p0 = 0, first = 0;  // first: index of entry (p0, p0)
  while (k >= first + m - p0) first += m - p0++;
  return make_int2(p0, p0 + (k - first));
}

// Workspace word of window slot 0 of chain row c (its slot s lives at
// base + s): the p links 0..l, then the r links 0..l-1, each over the
// slots it needs, link j of a chain of depth D over [H - e, W - H + e),
// e = (D - j) h
__device__ __forceinline__ int link_base(int c, int l, int h, int tile) {
  const bool pc = c <= l;
  const int j = pc ? c : c - l - 1;
  const int depth = pc ? l : l - 1;
  const int before = pc ? 0 : (l + 1) * tile + h * l * (l + 1);
  const int off = before + j * tile + 2 * h * (j * depth - j * (j - 1) / 2);
  return off - (l - (depth - j)) * h;
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

// band k of operator row g, where the caller knows g is stored
template <typename T, typename S, bool Ext>
__device__ __forceinline__ const S *band_ptr(const ChainArgs<T, S> &a,
                                             int k, long long g) {
  if constexpr (Ext)
    return a.bands + k * a.ldo + g + a.oext;
  else
    return a.bands + k * a.n + g;
}

// One butterfly step of gram_row: lanes that differ in bit 2W exchange
// half of their first 2W columns; a lane keeps columns [W, 2W) if that
// bit is set, else [0, W), plus its partner's copy, in v[0..W)
template <int W, typename T>
__device__ __forceinline__ void butterfly(T (&v)[16], int lane) {
  const bool hi = lane & (2 * W);
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const T send = hi ? v[i] : v[i + W];
    const T keep = hi ? v[i + W] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * W);
  }
}

// The CTA's sums of every thread's kGramGroup accumulators, stored by
// threads 0..kGramGroup-1 to ``row`` (each fences its store).  A warp
// transposes as it reduces: each butterfly step (lane offsets 16, 8, 4,
// 2) halves the columns a lane holds, so 15 shuffles leave lane L with
// column L >> 1 summed over the lanes that differ from L in bits 1-4, and
// one more adds lane L ^ 1; thread c then sums column c over the warps in
// warp order.  One fixed order, and 16 shuffles a warp where a tree a
// column takes 75.
template <typename T>
__device__ __forceinline__ void gram_row(const T (&acc)[kGramGroup],
                                         T *row) {
  __shared__ T red[kBlock / 32][16];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T v[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) v[c] = c < kGramGroup ? acc[c] : T(0);
  butterfly<8>(v, lane);
  butterfly<4>(v, lane);
  butterfly<2>(v, lane);
  butterfly<1>(v, lane);
  v[0] += __shfl_xor_sync(0xffffffffu, v[0], 1);
  if ((lane & 1) == 0) red[warp][lane >> 1] = v[0];
  __syncthreads();
  if (threadIdx.x < kGramGroup) {
    T sum = red[0][threadIdx.x];
    for (int w = 1; w < kBlock / 32; ++w) sum += red[w][threadIdx.x];
    row[threadIdx.x] = sum;
    __threadfence();
  }
  __syncthreads();
}

// CTAs an SM the launch bounds ask for (see "Occupancy" above)
template <int L> constexpr int chain_ctas() { return L == 2 ? 3 : 2; }

// L > 0: depth L and NB bands known to the compiler, the window one batch
// (tile + 2 L h <= kStep), the band values in registers.  L = 0: a.l, any
// window.
template <typename T, typename S, bool Ext, int NB, int L>
__global__ void __launch_bounds__(kBlock, chain_ctas<L>())
    ghost_chain_kernel(const ChainArgs<T, S> a) {
  static_assert(L == 0 || NB > 0, "registers hold a known band count");
  constexpr int R = kBatch, kStep = kBatch * kBlock, G = kGramGroup;
  extern __shared__ __align__(16) unsigned char dyn[];
  T *ws = a.scratch != nullptr ? a.scratch + blockIdx.x * a.ws
                               : reinterpret_cast<T *>(dyn);
  const int l = L > 0 ? L : a.l;
  const int nb = NB > 0 ? NB : a.offs.nb;
  const int h = a.h, H = l * h, tile = a.tile;
  const int W = tile + 2 * H;
  const int nbat = L > 0 ? 1 : (W + kStep - 1) / kStep;
  const long long base = static_cast<long long>(blockIdx.x) * tile;
  const long long g0 = base - H;  // row of window slot 0
  const int rows = static_cast<int>(min(static_cast<long long>(tile),
                                        a.n - base));
  // every window row is local (no strips, no bounds tests): all but the
  // end CTAs
  const bool inside = g0 >= 0 && g0 + W <= a.n;
  T bv[L > 0 ? R : 1][L > 0 ? NB : 1];  // the owned rows' band values

  // pass 0: p over [0, W), r over [h, W - h), the bands (L > 0; else
  // fetched into L2 for the later passes).  Interior CTAs issue every load
  // of a batch before the first is used, without bounds tests; the end
  // CTAs (strips, bounds tests) take a row at a time, so their registers
  // are not held four times.
  const int bp = link_base(0, l, h, tile);
  const int br = link_base(l + 1, l, h, tile);
  // window slot s's p and r into the workspace and, on own rows, into C
  auto put0 = [&](int s, T pv, T rv) {
    if (s < W) ws[bp + s] = pv;
    if (s >= h && s < W - h) ws[br + s] = rv;
    const int t = s - H;
    if (t >= 0 && t < rows) {
      a.chain[base + t] = Store<S>::of(pv);
      a.chain[(l + 1) * a.n + base + t] = Store<S>::of(rv);
    }
  };
  // the bands of slot s: into registers (L > 0), else fetched into L2 for
  // the later passes
  auto bands0 = [&](int q, int s, bool interior) {
    const long long g = g0 + s;
    const bool in = s >= h && s < W - h;
    if constexpr (L > 0) {
#pragma unroll
      for (int k = 0; k < NB; ++k)
        bv[q][k] = !in ? T(0)
                   : interior ? up<T>(*band_ptr<T, S, Ext>(a, k, g))
                              : band_at<T, S, Ext>(a, k, g);
    } else {
      const bool stored = Ext ? g >= -a.oext && g < a.n + a.oext
                              : g >= 0 && g < a.n;
      if (in && stored)
        for (int k = 0; k < nb; ++k)
          asm volatile("prefetch.global.L2 [%0];" ::"l"(
              band_ptr<T, S, Ext>(a, k, g)));
    }
  };
  auto pass0 = [&](auto interior) {
    constexpr bool kIn = decltype(interior)::value;
    for (int b = 0; b < nbat; ++b) {
      if constexpr (kIn) {
        // every load of the batch before the first is used
        T pv[R], rv[R];
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const int s = b * kStep + q * kBlock + threadIdx.x;
          const long long g = g0 + s;
          pv[q] = s < W ? up<T>(a.p[g]) : T(0);
          rv[q] = s >= h && s < W - h ? up<T>(a.r[g]) : T(0);
          bands0(q, s, true);
        }
#pragma unroll
        for (int q = 0; q < R; ++q)
          put0(b * kStep + q * kBlock + threadIdx.x, pv[q], rv[q]);
      } else {
        // the end CTAs, with strips and bounds tests: a row at a time
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const int s = b * kStep + q * kBlock + threadIdx.x;
          const long long g = g0 + s;
          const T pv = s < W ? vec_at<T, S>(a.p, a.p_lo, a.p_hi, 0, g, a.n,
                                            a.hs)
                             : T(0);
          const T rv = s >= h && s < W - h
                           ? vec_at<T, S>(a.r, a.r_lo, a.r_hi, 0, g, a.n,
                                          a.hs)
                           : T(0);
          bands0(q, s, false);
          put0(s, pv, rv);
        }
      }
    }
  };
  if (inside)
    pass0(std::true_type{});
  else
    pass0(std::false_type{});
  __syncthreads();
  const T thi = T(1) / (a.theta != nullptr ? *a.theta : a.theta_value);

  // pass j: link j of p over [j h, W - j h) and, for j < l, of r over
  // [(j+1) h, W - (j+1) h)
#pragma unroll
  for (int j = 1; j <= (L > 0 ? L : a.l); ++j) {
    const int pp = link_base(j - 1, l, h, tile), pj = link_base(j, l, h, tile);
    const int rp = link_base(l + j, l, h, tile);
    const int rj = link_base(l + 1 + j, l, h, tile);
    const int ep = j * h, er = (j + 1) * h;
    const bool rlink = j < l;
    // link j at slot s from its sums, into the workspace and, on the
    // tile's own rows, into C
    auto put = [&](int s, bool pin, bool rin, T ps, T rs) {
      const int t = s - H;
      const bool own = t >= 0 && t < rows;
      if (pin) {
        const T v = ps * thi;
        ws[pj + s] = v;
        if (own) a.chain[j * a.n + base + t] = Store<S>::of(v);
      }
      if (rin) {
        const T v = rs * thi;
        ws[rj + s] = v;
        if (own) a.chain[(l + 1) * a.n + j * a.n + base + t] =
            Store<S>::of(v);
      }
    };
    if constexpr (L > 0) {
      // a row at a time: its stores come before the next row's loads, so
      // the compiler holds one row's shared-memory operands, not four
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int s = q * kBlock + threadIdx.x;
        const bool pin = s >= ep && s < W - ep;
        const bool rin = rlink && s >= er && s < W - er;
        T ps = T(0), rs = T(0);
#pragma unroll
        for (int k = 0; k < NB; ++k) {
          const int o = a.offs.off[k];
          if (pin) ps = ps + bv[q][k] * ws[pp + s + o];
          if (rin) rs = rs + bv[q][k] * ws[rp + s + o];
        }
        put(s, pin, rin, ps, rs);
      }
    } else {
      // every row's band loads of a band at once (they come from L2)
      for (int b = 0; b < nbat; ++b) {
        T ps[R], rs[R];
        bool pin[R], rin[R];
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const int s = b * kStep + q * kBlock + threadIdx.x;
          pin[q] = s >= ep && s < W - ep;
          rin[q] = rlink && s >= er && s < W - er;
          ps[q] = T(0);
          rs[q] = T(0);
        }
#pragma unroll 4
        for (int k = 0; k < nb; ++k) {
          const int o = a.offs.off[k];
          T bk[R];
#pragma unroll
          for (int q = 0; q < R; ++q)
            bk[q] = pin[q] ? band_at<T, S, Ext>(
                                 a, k, g0 + b * kStep + q * kBlock +
                                           threadIdx.x)
                           : T(0);
#pragma unroll
          for (int q = 0; q < R; ++q) {
            const int s = b * kStep + q * kBlock + threadIdx.x;
            if (pin[q]) ps[q] = ps[q] + bk[q] * ws[pp + s + o];
            if (rin[q]) rs[q] = rs[q] + bk[q] * ws[rp + s + o];
          }
        }
#pragma unroll
        for (int q = 0; q < R; ++q)
          put(b * kStep + q * kBlock + threadIdx.x, pin[q], rin[q], ps[q],
              rs[q]);
      }
    }
    if (j < l) __syncthreads();
  }

  // the Gram: each thread's products over its own rows below n_valid, a
  // group of kGramGroup pairs at a time (a row at a time, so nothing
  // spills), each group's CTA row stored by gram_row
  const int nv = static_cast<int>(
      max(0LL, min(static_cast<long long>(tile), a.n_valid - base)));
  const int m = 2 * l + 1;
  const int ngroups = (a.nblk + kGroup - 1) / kGroup;
  const long long ldp = static_cast<long long>(a.nblk + ngroups) * G;
  // pair groups (known to the compiler when L is)
  constexpr int kGroups = L > 0 ? ((2 * L + 1) * (L + 1) + G - 1) / G : 0;
  const int ngr = L > 0 ? kGroups : (a.npairs + G - 1) / G;
  if constexpr (L > 0) {
    constexpr int M = 2 * L + 1;
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi) {
      T acc[G];
#pragma unroll
      for (int c = 0; c < G; ++c) acc[c] = T(0);
#pragma unroll 1
      for (int q = 0; q < R; ++q) {
        const int s = q * kBlock + threadIdx.x;
        const int t = s - H;
        if (t < 0 || t >= nv) continue;
        T cv[M];
#pragma unroll
        for (int c = 0; c < M; ++c) cv[c] = ws[link_base(c, L, h, tile) + s];
        int k = 0;  // pair (i, j)'s index, known to the compiler
#pragma unroll
        for (int i = 0; i < M; ++i)
#pragma unroll
          for (int j = i; j < M; ++j, ++k)
            if (k >= gi * G && k < (gi + 1) * G)
              acc[k - gi * G] = acc[k - gi * G] + cv[i] * cv[j];
      }
      gram_row(acc, a.partials + gi * ldp + blockIdx.x * G);
    }
  } else {
    __shared__ int2 pb[G];  // the group's pairs' link bases
    for (int gi = 0; gi < ngr; ++gi) {
      if (threadIdx.x < G && gi * G + threadIdx.x < a.npairs) {
        const int2 ij = pair_of(gi * G + threadIdx.x, m);
        pb[threadIdx.x] = make_int2(link_base(ij.x, l, h, tile),
                                    link_base(ij.y, l, h, tile));
      }
      __syncthreads();
      T acc[G];
#pragma unroll
      for (int c = 0; c < G; ++c) acc[c] = T(0);
      for (int b = 0; b < nbat; ++b) {
#pragma unroll 1
        for (int q = 0; q < R; ++q) {
          const int s = b * kStep + q * kBlock + threadIdx.x;
          const int t = s - H;
          if (t < 0 || t >= nv) continue;
#pragma unroll
          for (int c = 0; c < G; ++c) {
            if (gi * G + c < a.npairs) {
              const int2 bij = pb[c];
              acc[c] = acc[c] + ws[bij.x + s] * ws[bij.y + s];
            }
          }
        }
      }
      gram_row(acc, a.partials + gi * ldp + blockIdx.x * G);
    }
  }

  // the finish, in finish_rows' two-level order with one ticket a CTA for
  // every pair group: the last CTA of each group of kGroup CTAs sums the
  // group's rows, the last group the group rows, and fills the Gram
  const int g = blockIdx.x / kGroup;
  const int gsize = min(kGroup, a.nblk - g * kGroup);
  if (!arrive(a.tickets + g, gsize)) return;
#pragma unroll
  for (int gi = 0; gi < ngr; ++gi) {
    T *part = a.partials + gi * ldp;
    T v[G];
    sum_rows<T, G>(part + static_cast<long long>(g) * kGroup * G, gsize, v);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int c = 0; c < G; ++c) part[(a.nblk + g) * G + c] = v[c];
    }
  }
  if (threadIdx.x == 0) a.tickets[g] = 0;
  __syncthreads();  // every thread has read the first arrival's verdict
  if (!arrive(a.tickets + ngroups, ngroups)) return;
#pragma unroll
  for (int gi = 0; gi < ngr; ++gi) {
    T v[G];
    sum_rows<T, G>(a.partials + gi * ldp + static_cast<long long>(a.nblk) * G,
                   ngroups, v);
    if (threadIdx.x == 0) {
      for (int c = 0; c < G && gi * G + c < a.npairs; ++c) {
        const int2 ij = pair_of(gi * G + c, m);
        a.gram[ij.x * m + ij.y] = v[c];
        a.gram[ij.y * m + ij.x] = v[c];
      }
    }
  }
  if (threadIdx.x == 0) a.tickets[ngroups] = 0;
}

template <typename T, typename S, bool Ext, int NB, int L>
static int launch_chain_k(const ChainArgs<T, S> &a, cudaStream_t st) {
  static int granted[kMaxDevices] = {};
  int smem = 0;
  if (a.scratch == nullptr) {
    if (a.ws * static_cast<long long>(sizeof(T)) > 232448)
      return static_cast<int>(cudaErrorInvalidValue);
    smem = static_cast<int>(a.ws * static_cast<long long>(sizeof(T)));
    const int e = set_smem(
        reinterpret_cast<const void *>(ghost_chain_kernel<T, S, Ext, NB, L>),
        smem, granted);
    if (e) return e;
  }
  ghost_chain_kernel<T, S, Ext, NB, L><<<a.nblk, kBlock, smem, st>>>(a);
  return 0;
}

// the main path's sweeps (the tridiagonal operator at l = 2 and 4, one
// batch a window) and the 5-point operator get their own instantiations
template <typename T, typename S, bool Ext>
int launch_chain(const ChainArgs<T, S> &a, cudaStream_t st) {
  const bool one = a.tile + 2LL * a.l * a.h <= kBatch * kBlock;
  if (a.offs.nb == 3 && one && a.l == 2)
    return launch_chain_k<T, S, Ext, 3, 2>(a, st);
  if (a.offs.nb == 3 && one && a.l == 4)
    return launch_chain_k<T, S, Ext, 3, 4>(a, st);
  if (a.offs.nb == 5) return launch_chain_k<T, S, Ext, 5, 0>(a, st);
  return launch_chain_k<T, S, Ext, 0, 0>(a, st);
}

}  // namespace rt

extern "C" int rt_ghost_chain(
    int acc, int sto, const int *offsets, int nb, long long n, int l,
    const void *bands, int oext, const void *p, const void *r,
    const void *p_lo, const void *p_hi, const void *r_lo, const void *r_hi,
    int hs, long long n_valid, const void *theta, double theta_value,
    void *chain, int tile, void *scratch, long long ws, void *partials,
    int nblk, void *tickets, void *gram, void *stream) {
  using namespace rt;
  int h = 0;
  for (int b = 0; b < nb && nb <= kMaxBands; ++b) {
    const int o = offsets[b] < 0 ? -offsets[b] : offsets[b];
    h = o > h ? o : h;
  }
  const int m = 2 * l + 1;
  if (nb < 1 || nb > kMaxBands || n < 1 || l < 1 || tile < 1 ||
      nblk != (n + tile - 1) / tile || oext < 0 || hs < 0 ||
      tickets == nullptr || partials == nullptr ||
      ws < static_cast<long long>(m) * tile + 2LL * l * l * h)
    return static_cast<int>(cudaErrorInvalidValue);
  Offsets offs{};
  offs.nb = nb;
  for (int b = 0; b < nb; ++b) offs.off[b] = offsets[b];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
    g.npairs = m * (m + 1) / 2;
    g.nblk = nblk;
    g.ws = ws;
    g.bands = static_cast<const S *>(bands);
    g.p = static_cast<const S *>(p);
    g.r = static_cast<const S *>(r);
    g.p_lo = static_cast<const S *>(p_lo);
    g.p_hi = static_cast<const S *>(p_hi);
    g.r_lo = static_cast<const S *>(r_lo);
    g.r_hi = static_cast<const S *>(r_hi);
    g.theta = static_cast<const T *>(theta);
    g.theta_value = static_cast<T>(theta_value);
    g.chain = static_cast<S *>(chain);
    g.partials = static_cast<T *>(partials);
    g.gram = static_cast<T *>(gram);
    g.tickets = static_cast<unsigned int *>(tickets);
    g.scratch = static_cast<T *>(scratch);
    return oext > 0 ? launch_chain<T, S, true>(g, st)
                    : launch_chain<T, S, false>(g, st);
  });
  if (rc) return rc;
  return static_cast<int>(cudaGetLastError());
}
