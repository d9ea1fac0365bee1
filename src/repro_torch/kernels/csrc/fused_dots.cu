// Fused multi-vector inner products: dots[j] = <V[j], z> for V (m, n).
//
// Replaces the Pallas TPU kernel repro/kernels/fused_dots.py::fused_dots:
// all m coefficients (the sharded PIPECG body's init partials, the
// (P)GMRES orthogonalisation row) in one pass over V.
//
// Bound on the H100: bytes.  The pass must read V and z once, (m + 1) n
// words, for 2 m n flops: 5.0 us at m = 3, n = 524,288 in float64.  At
// that size a second launch's ramp, tail and gap are a large share of the
// time, so the launch is one kernel that also finishes the sums.
//
// Design.
// * A grid of at most kDotsMaxBlocks CTAs (two an SM on 132 SMs): each
//   thread takes ITEMS vectors of W columns (16-byte loads, double2 or
//   float4, where n and both pointers allow; single words otherwise),
//   neighbouring threads on neighbouring vectors.  It loads its z once
//   into registers and reuses them for every row of V; a wide V (m > 4)
//   it streams with evict-first loads, which on an H100 brought the GMRES
//   width, m = 30 at n = 2,097,152, below torch.mv.  ITEMS is the
//   smallest of 1, 2, 4, 8 that keeps the grid within kDotsMaxBlocks
//   (kernels/fused_dots.py::dots_plan picks it).
// * Rows of V go ROWS at a time (4 where m <= 4, else 8: fewer block
//   reductions for a wide V, fewer idle registers for a narrow one)
//   through one deterministic block reduction, in batches of up to
//   kDotsLoads / ITEMS rows whose loads are all issued before the first
//   is used.  Thread 0 stores the CTA's row of partials, (groups, nblk, ROWS)
//   with groups = ceil(m / ROWS).
// * The last CTA to arrive (integer tickets, common.cuh::arrive) sums the
//   partials of each group of columns in a fixed order (common.cuh::
//   sum_rows) and writes the m results: one launch, no float atomics, an
//   order that depends only on (nblk, m), so results repeat bit for bit.
//   It sets the ticket back to 0.
#include "common.cuh"

namespace rt {

constexpr int kDotsMaxBlocks = 264;   // CTAs a launch aims at: 2 x 132 SMs
constexpr int kDotsVecBytes = 16;     // bytes a vector load
constexpr int kDotsLoads = 8;         // vector loads a thread has in flight

// W columns, loaded as one (16-byte) word
template <typename T, int W> struct alignas(sizeof(T) * W) Vec { T x[W]; };

// a V word; streamed (evict first) where V is the wide GMRES basis, far
// larger than L2, so that it does not push z and the partials out; a
// narrow V (m <= 4, the rank init's few vectors) keeps the default
template <bool Stream, typename T, int W>
__device__ __forceinline__ Vec<T, W> load_v(const Vec<T, W> *p) {
  Vec<T, W> out;
  if constexpr (!Stream) {
    out = *p;
  } else if constexpr (W == 2 && sizeof(T) == 8) {
    const double2 d = __ldcs(reinterpret_cast<const double2 *>(p));
    out.x[0] = d.x, out.x[1] = d.y;
  } else if constexpr (W == 4 && sizeof(T) == 4) {
    const float4 f = __ldcs(reinterpret_cast<const float4 *>(p));
    out.x[0] = f.x, out.x[1] = f.y, out.x[2] = f.z, out.x[3] = f.w;
  } else {
    out.x[0] = __ldcs(reinterpret_cast<const T *>(p));
  }
  return out;
}

template <typename T, int W, int ITEMS, int ROWS>
__global__ void __launch_bounds__(kBlock, 2)
fused_dots_kernel(const T *__restrict__ V, const T *__restrict__ z,
                  long long n, int m, int nblk, T *__restrict__ partials,
                  unsigned int *tickets, T *__restrict__ out) {
  using Vw = Vec<T, W>;
  // rows a batch: kDotsLoads vector loads, within a group
  constexpr int kB = ITEMS >= kDotsLoads          ? 1
                     : kDotsLoads / ITEMS < ROWS ? kDotsLoads / ITEMS
                                                 : ROWS;
  const long long nv = n / W;  // W > 1 only where W divides n
  const long long v0 =
      static_cast<long long>(blockIdx.x) * kBlock * ITEMS + threadIdx.x;
  const Vw *Vv = reinterpret_cast<const Vw *>(V);
  const Vw *zv = reinterpret_cast<const Vw *>(z);
  Vw zt[ITEMS];
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const long long c = v0 + static_cast<long long>(it) * kBlock;
    if (c < nv) {
      zt[it] = zv[c];
    } else {
#pragma unroll
      for (int w = 0; w < W; ++w) zt[it].x[w] = T(0);
    }
  }
  const int groups = (m + ROWS - 1) / ROWS;
  for (int g = 0; g < groups; ++g) {
    const int j0 = g * ROWS;
    T s[ROWS];
#pragma unroll
    for (int q = 0; q < ROWS; ++q) s[q] = T(0);
#pragma unroll
    for (int jb = 0; jb < ROWS; jb += kB) {
      if (j0 + jb < m) {
        Vw x[kB][ITEMS];
#pragma unroll
        for (int q = 0; q < kB; ++q)
#pragma unroll
          for (int it = 0; it < ITEMS; ++it) {
            const long long c = v0 + static_cast<long long>(it) * kBlock;
            if (j0 + jb + q < m && c < nv) {
              x[q][it] = load_v<(ROWS > 4)>(
                  Vv + static_cast<long long>(j0 + jb + q) * nv + c);
            } else {
#pragma unroll
              for (int w = 0; w < W; ++w) x[q][it].x[w] = T(0);
            }
          }
#pragma unroll
        for (int q = 0; q < kB; ++q)
#pragma unroll
          for (int it = 0; it < ITEMS; ++it)
#pragma unroll
            for (int w = 0; w < W; ++w)
              s[jb + q] = s[jb + q] + x[q][it].x[w] * zt[it].x[w];
      }
    }
    block_reduce<T, ROWS>(s);
    if (threadIdx.x == 0) {
      T *row = partials + (static_cast<long long>(g) * nblk + blockIdx.x) *
                              ROWS;
#pragma unroll
      for (int q = 0; q < ROWS; ++q) row[q] = s[q];
    }
  }
  if (!arrive(tickets, nblk)) return;
  for (int g = 0; g < groups; ++g) {
    T v[ROWS];
    sum_rows<T, ROWS>(
        partials + static_cast<long long>(g) * nblk * ROWS, nblk, v);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int q = 0; q < ROWS; ++q)
        if (g * ROWS + q < m) out[g * ROWS + q] = v[q];
    }
  }
  if (threadIdx.x == 0) tickets[0] = 0;
}

template <typename T, int W, int ROWS>
static int launch_dots(const void *V, const void *z, long long n, int m,
                       int items, void *partials, int nblk,
                       unsigned int *tickets, void *out, cudaStream_t st) {
  auto go = [&](auto kernel) {
    kernel<<<nblk, kBlock, 0, st>>>(
        static_cast<const T *>(V), static_cast<const T *>(z), n, m, nblk,
        static_cast<T *>(partials), tickets, static_cast<T *>(out));
    return 0;
  };
  switch (items) {
    case 1: return go(fused_dots_kernel<T, W, 1, ROWS>);
    case 2: return go(fused_dots_kernel<T, W, 2, ROWS>);
    case 4: return go(fused_dots_kernel<T, W, 4, ROWS>);
    case 8: return go(fused_dots_kernel<T, W, 8, ROWS>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int W>
static int launch_rows(const void *V, const void *z, long long n, int m,
                       int items, int rows, void *partials, int nblk,
                       unsigned int *tickets, void *out, cudaStream_t st) {
  switch (rows) {
    case 4:
      return launch_dots<T, W, 4>(V, z, n, m, items, partials, nblk, tickets,
                                  out, st);
    case 8:
      return launch_dots<T, W, 8>(V, z, n, m, items, partials, nblk, tickets,
                                  out, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace rt

// dots (m,) of V (m, n) and z (n,), both of dtype code dt (f32 or f64),
// contiguous.  width: columns a load, 1 or 16 bytes' worth (then width
// divides n and V and z start on 16 bytes); items: vectors a thread, 1, 2,
// 4 or 8; rows: rows of V a block reduction, 4 or 8; nblk = ceil(n / width
// / (kBlock * items)) CTAs; partials: ceil(m / rows) * nblk * rows words
// of scratch; tickets: one zero counter (zero again when the launch ends).
// Returns a cudaError_t (0 on success).
extern "C" int rt_fused_dots(int dt, const void *V, const void *z,
                             long long n, int m, int width, int items,
                             int rows, void *partials, int nblk,
                             void *tickets, void *out, void *stream) {
  using namespace rt;
  if (n < 1 || m < 1 || width < 1 || n % width || items < 1 ||
      nblk != (n / width + static_cast<long long>(kBlock) * items - 1) /
                  (static_cast<long long>(kBlock) * items))
    return static_cast<int>(cudaErrorInvalidValue);
  if (width > 1 && (reinterpret_cast<unsigned long long>(V) % kDotsVecBytes ||
                    reinterpret_cast<unsigned long long>(z) % kDotsVecBytes))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned int *tk = static_cast<unsigned int *>(tickets);
  int rc;
  switch (dt) {
    case kF32:
      rc = width == 1   ? launch_rows<float, 1>(V, z, n, m, items, rows,
                                                partials, nblk, tk, out, st)
           : width == 4 ? launch_rows<float, 4>(V, z, n, m, items, rows,
                                                partials, nblk, tk, out, st)
                        : static_cast<int>(cudaErrorInvalidValue);
      break;
    case kF64:
      rc = width == 1   ? launch_rows<double, 1>(V, z, n, m, items, rows,
                                                 partials, nblk, tk, out, st)
           : width == 2 ? launch_rows<double, 2>(V, z, n, m, items, rows,
                                                 partials, nblk, tk, out, st)
                        : static_cast<int>(cudaErrorInvalidValue);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc) return rc;
  return static_cast<int>(cudaGetLastError());
}
