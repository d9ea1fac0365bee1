// Shared pieces of the port's CUDA kernels (sm_90a, plain C interface).
//
// dtype codes, the storage <-> accumulator conversions, the band-offset
// parameter block, a deterministic block reduction, the fixed-order row
// sum that finishes every cross-block sum (as a second kernel,
// reduce_rows_kernel, or inside a sweep by ticketed CTAs, finish_rows),
// and the row-window table of the two DIA sweeps.  Cross-block sums never
// use float atomics: each CTA writes its partials to a (k, n_blocks, NC)
// scratch tensor and they are summed in a fixed order, so a result is
// bit-identical from run to run.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace rt {

// dtype codes; kernels/build.py keeps the same table
enum DType : int { kF32 = 0, kF64 = 1, kBF16 = 2, kFP8E4M3 = 3 };

// rows per CTA of every row-parallel kernel (one thread per row)
constexpr int kBlock = 256;
// rows a thread of the DIA sweeps takes at once: every load of the batch
// starts before the first is used, so each thread keeps several rows'
// bytes in flight
constexpr int kBatch = 4;
// the most bands a DIA operator may carry: glen_law_band(bandwidth <= 15);
// the paper's second operator, glen_law_band(bandwidth=10), has 21.  Only
// the Offsets parameter block is sized by it (132 bytes); no per-thread
// array is
constexpr int kMaxBands = 32;

struct Offsets {
  int nb;
  int off[kMaxBands];
};

// fp8 e4m3 storage as raw bits; converted with the documented intrinsics
struct e4m3 {
  __nv_fp8_storage_t bits;
};

template <typename T> struct Tag { using type = T; };

// ---- loads: storage -> accumulator ------------------------------------
template <typename T> __device__ __forceinline__ T up(float v) {
  return static_cast<T>(v);
}
template <typename T> __device__ __forceinline__ T up(double v) {
  return static_cast<T>(v);
}
template <typename T> __device__ __forceinline__ T up(__nv_bfloat16 v) {
  return static_cast<T>(__bfloat162float(v));
}
template <typename T> __device__ __forceinline__ T up(e4m3 v) {
  const __half_raw hr = __nv_cvt_fp8_to_halfraw(v.bits, __NV_E4M3);
  return static_cast<T>(__half2float(__half(hr)));
}

// ---- stores: accumulator -> storage (narrowing goes through float, as
// torch's .to(bfloat16) / .to(float8_e4m3fn) do) --------------------------
template <typename S> struct Store;
template <> struct Store<float> {
  template <typename T> __device__ static float of(T v) {
    return static_cast<float>(v);
  }
};
template <> struct Store<double> {
  template <typename T> __device__ static double of(T v) {
    return static_cast<double>(v);
  }
};
template <> struct Store<__nv_bfloat16> {
  template <typename T> __device__ static __nv_bfloat16 of(T v) {
    return __float2bfloat16(static_cast<float>(v));
  }
};
template <> struct Store<e4m3> {
  template <typename T> __device__ static e4m3 of(T v) {
    e4m3 o;
    o.bits = __nv_cvt_float_to_fp8(static_cast<float>(v), __NV_NOSAT,
                                   __NV_E4M3);
    return o;
  }
};

// ---- host-side dtype dispatch ------------------------------------------
template <typename T, typename F> int with_storage(int sto, F &f) {
  switch (sto) {
    case kF32: return f(Tag<T>{}, Tag<float>{});
    case kF64: return f(Tag<T>{}, Tag<double>{});
    case kBF16: return f(Tag<T>{}, Tag<__nv_bfloat16>{});
    case kFP8E4M3: return f(Tag<T>{}, Tag<e4m3>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// f(Tag<accumulator>, Tag<storage>) for accumulator in {f32, f64}
template <typename F> int with_types(int acc, int sto, F &&f) {
  switch (acc) {
    case kF32: return with_storage<float>(sto, f);
    case kF64: return with_storage<double>(sto, f);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// f(Tag<T>) for T in {f32, f64}: kernels that store nothing narrower
template <typename F> int with_accum(int acc, F &&f) {
  switch (acc) {
    case kF32: return f(Tag<float>{});
    case kF64: return f(Tag<double>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// row m of right-hand side j of a carried (k, n) vector: the local rows,
// else the (k, h2) strips to the left and right (null: zero), else zero
template <typename T, typename S>
__device__ __forceinline__ T vec_at(const S *v, const S *lo, const S *hi,
                                    long long j, long long m, long long n,
                                    int h2) {
  if (m >= 0 && m < n) return up<T>(v[j * n + m]);
  if (m < 0) return (lo != nullptr && m >= -h2) ? up<T>(lo[j * h2 + m + h2])
                                                : T(0);
  return (hi != nullptr && m < n + h2) ? up<T>(hi[j * h2 + (m - n)]) : T(0);
}

inline long long blocks_for(long long n) { return (n + kBlock - 1) / kBlock; }

// ---- deterministic block reduction --------------------------------------
// Sums v[c] over the CTA (blockDim.x a multiple of 32, at most 1024);
// the totals are valid in thread 0.  Warp shuffles in a fixed tree, then
// warp 0 over the per-warp sums: the same order on every run.
template <typename T, int NV>
__device__ __forceinline__ void block_reduce(T (&v)[NV]) {
  __shared__ T smem[32][NV];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    T x = v[c];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    v[c] = x;
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < NV; ++c) smem[warp][c] = v[c];
  }
  __syncthreads();
  const int nwarps = (blockDim.x + 31) >> 5;
  if (warp == 0) {
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      T x = lane < nwarps ? smem[lane][c] : T(0);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        x += __shfl_down_sync(0xffffffffu, x, o);
      v[c] = x;
    }
  }
  __syncthreads();  // smem may be reused by the caller's next reduction
}

// v[c] = sum_b rows[b * NC + c] over b in [0, nblk), valid in thread 0.
// Thread t sums rows t, t + blockDim.x, ... from zero, then block_reduce's
// tree: one order, whichever CTA runs it.  Wide rows (NC > 8, the
// p-BiCGStab payload) of at most 32 take warp 0 alone, a row a lane and
// one shuffle tree, which spares a CTA-wide reduction at the end of the
// launch; narrow rows keep the block path, whose code fits the 64
// registers the PIPECG sweep is held to.  The loads bypass L1, so a CTA
// may sum rows other CTAs wrote during the same launch (finish_rows).
template <typename T, int NC>
__device__ __forceinline__ void sum_rows(const T *rows, int nblk,
                                         T (&v)[NC]) {
#pragma unroll
  for (int c = 0; c < NC; ++c) v[c] = T(0);
  if (NC > 8 && nblk <= 32) {
    if (threadIdx.x < 32) {
      if (static_cast<int>(threadIdx.x) < nblk) {
#pragma unroll
        for (int c = 0; c < NC; ++c)
          v[c] += __ldcg(rows + threadIdx.x * NC + c);
      }
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          v[c] += __shfl_down_sync(0xffffffffu, v[c], o);
    }
    return;
  }
#pragma unroll 4
  for (int b = threadIdx.x; b < nblk; b += blockDim.x) {
    const T *row = rows + static_cast<long long>(b) * NC;
#pragma unroll
    for (int c = 0; c < NC; ++c) v[c] += __ldcg(row + c);
  }
  block_reduce<T, NC>(v);
}

// red[j, c] = sum_b partials[j, b, c] in a fixed order; grid (k), block kBlock
template <typename T, int NC>
__global__ void reduce_rows_kernel(const T *__restrict__ partials,
                                   T *__restrict__ red, int nblk) {
  const long long j = blockIdx.x;
  T v[NC];
  sum_rows<T, NC>(partials + j * nblk * NC, nblk, v);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < NC; ++c) red[j * NC + c] = v[c];
  }
}

// True in every thread of the CTA that is the count-th to arrive at
// *ticket.  Call after thread 0 has stored what the last arrival must
// read: it fences that, draws an integer ticket, and the CTA that draws
// count - 1 then sees every earlier arrival's stores.
__device__ __forceinline__ bool arrive(unsigned int *ticket,
                                       unsigned int count) {
  __shared__ bool last;
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1u) == count - 1;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// CTAs per group of the two-level finish
constexpr int kGroup = 32;

// Finish one launch row's (nblk, NC) partial rows, each CTA's row already
// stored by its thread 0, in a fixed order with integer tickets (no float
// atomics).  Narrow rows (NC <= 8), up to kOneLevel of them (one batch of
// loads a thread): the last CTA to arrive sums them all (sum_rows).
// Otherwise in two levels, so most of the sum overlaps the other CTAs'
// work: the last CTA of each group of kGroup consecutive CTAs sums the
// group's rows into row g of grp, then the last group to finish sums the
// (ngroups, NC) group rows.  True (v valid in thread 0) in the one CTA
// that finished.  Every ticket is back at 0 when the launch ends.
// tickets: ngroups + 1 counters.  The order depends only on nblk, never
// on which CTA comes last.
constexpr int kOneLevel = 4 * kBlock;

template <typename T, int NC>
__device__ __forceinline__ bool finish_rows(const T *part, T *grp,
                                            unsigned int *tickets, int nblk,
                                            T (&v)[NC]) {
  if (NC <= 8 && nblk <= kOneLevel) {
    if (!arrive(tickets, nblk)) return false;
    sum_rows<T, NC>(part, nblk, v);
    if (threadIdx.x == 0) tickets[0] = 0;
    return true;
  }
  const int g = blockIdx.x / kGroup;
  const int ngroups = (nblk + kGroup - 1) / kGroup;
  const int gsize = min(kGroup, nblk - g * kGroup);
  if (!arrive(tickets + g, gsize)) return false;
  sum_rows<T, NC>(part + static_cast<long long>(g) * kGroup * NC, gsize, v);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < NC; ++c) grp[g * NC + c] = v[c];
    tickets[g] = 0;
  }
  if (!arrive(tickets + ngroups, ngroups)) return false;
  sum_rows<T, NC>(grp, ngroups, v);
  if (threadIdx.x == 0) tickets[ngroups] = 0;
  return true;
}

// ---- row windows of the DIA sweeps ----------------------------------------
// A sweep CTA owns rows [i0, i0 + tile).  Its second SpMV reads the inner
// vector (u', w') on rows i0 + e for e in the inner shifts D1 + [0, tile),
// D1 = offsets and 0, and each of those reads the outer vector (p', z) on
// rows shifted once more: D2 = D1 and every d + off, d in D1, off in
// offsets.  Each set of intervals
// [d, d + tile) is merged into clusters, and a cluster's rows sit in
// consecutive slots of a shared-memory window, so a 2-D Laplacian's
// +-nx bands cost three inner and five outer tile-sized clusters, not a
// +-2nx window.  The wrapper builds the table once per operator
// (kernels/pipecg_spmv_fused.py::window_table); every CTA copies it to
// shared memory.  Layout (ints):
//   [0] n2, [1] n1: outer and inner clusters    [2] w2, [3] w1: their slots
//   [4] c_own: the inner cluster holding the tile's own rows
//   [5] o1, [6] o2: own row t sits in inner slot o1 + t, outer slot o2 + t
//   [7] 0
//   then (lo, width, base) per outer cluster, then per inner cluster:
//   slot base + s holds row i0 + lo + s;
//   then dtab (n1, nb + 1): the outer slot of row i0 + e + off_b, for e in
//   inner cluster c, is e + dtab[c][b]; b = nb: of row i0 + e itself;
//   then wtab (nb): the inner slot of row i0 + t + off_b is t + wtab[b].
struct Window {
  int n2, n1, w2, w1, c_own, o1, o2;
  const int *cl2, *cl1, *dtab, *wtab;
};

// Copy the table into the head of dynamic shared memory (bytes: its
// 16-byte aligned size) and sync; the windows follow it.
__device__ __forceinline__ Window stage_window(unsigned char *dyn,
                                               const int *__restrict__ plan,
                                               int len, int nb) {
  int *tab = reinterpret_cast<int *>(dyn);
  for (int q = threadIdx.x; q < len; q += blockDim.x) tab[q] = plan[q];
  __syncthreads();
  Window w;
  w.n2 = tab[0];
  w.n1 = tab[1];
  w.w2 = tab[2];
  w.w1 = tab[3];
  w.c_own = tab[4];
  w.o1 = tab[5];
  w.o2 = tab[6];
  w.cl2 = tab + 8;
  w.cl1 = w.cl2 + 3 * w.n2;
  w.dtab = w.cl1 + 3 * w.n1;
  w.wtab = w.dtab + w.n1 * (nb + 1);
  return w;
}

// row m of a vector, as vec_at, where the caller knows whether the rows it
// reads all lie in [0, n) (inside: no bounds test)
template <typename T, typename S>
__device__ __forceinline__ T row_at(const S *v, const S *lo, const S *hi,
                                    long long j, long long m, long long n,
                                    int h2, bool inside) {
  return inside ? up<T>(v[j * n + m]) : vec_at<T, S>(v, lo, hi, j, m, n, h2);
}

// band b of operator row m (stored at column m + oext of an
// (n_bands, n + 2 oext) array), zero beyond the stored rows
template <typename T, typename S, bool Ext>
__device__ __forceinline__ T band_row(const S *bands, int b, long long m,
                                      long long n, long long ldo, int oext) {
  if constexpr (Ext)
    return (m >= -oext && m < n + oext) ? up<T>(bands[b * ldo + m + oext])
                                        : T(0);
  else
    return (m >= 0 && m < n) ? up<T>(bands[b * n + m]) : T(0);
}

// Opt a kernel into ``bytes`` of dynamic shared memory where that and its
// static buffers (at most 16 KB: block_reduce's) may pass the 48 KB a
// launch gets without opting in.  The attribute call is a CUDA runtime
// round trip, too slow for every launch of a solver loop, so it is made once
// per device and size: ``granted`` is the kernel's record, a static of
// its launcher, which has internal linkage (``static``) so that the
// record stays in its own library (the static of a template with external
// linkage would be merged across loaded libraries).
constexpr int kMaxDevices = 64;

inline int set_smem(const void *kernel, int bytes,
                    int (&granted)[kMaxDevices]) {
  if (bytes + 16 * 1024 <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < kMaxDevices && granted[dev] >= bytes) return 0;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < kMaxDevices) granted[dev] = bytes;
  return static_cast<int>(e);
}

}  // namespace rt
